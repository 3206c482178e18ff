// What kernels D and E (fullprob_fwd.cu, fullprob_bwd.cu) share: the
// maxima of their one barrier a diagonal (a block's, or a thread block
// cluster's in the linear cluster build), the launch of a cluster, and
// the launch of the fan-in build that a launch plan names
// (align/fullprob_fill.py::fwd_fanin_plan, ::bwd_fanin_plan).
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

// maximum over the block of the warp maxima in row[0 .. nw): every
// warp reduces the whole row itself
__device__ __forceinline__ float row_max(const float* row, int nw) {
  const int l = threadIdx.x & 31;
  float r = l < nw ? row[l] : 0.0f;
  for (int o = 16; o > 0; o >>= 1)
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

// the warp's maximum of v, written to row[warp] by its lane 0
__device__ __forceinline__ void warp_max(float v, float* row) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) row[threadIdx.x >> 5] = v;
}

// lets `kernel` take smem bytes of dynamic shared memory; a refusal is
// returned and cleared, so that no later launch reports it
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// ---------------------------------------------------------------- clusters
// The linear cluster build: one thread block cluster of C CTAs a job
// (grid C B along x, cluster C x 1 x 1: the C CTAs of a job are
// contiguous), the lanes split into C ranges. Every
// CTA holds the maxima of all C CTAs in its own shared row; the
// neighbours hand their edge lanes over through distributed shared
// memory; one cluster barrier a diagonal orders it all.

// the largest cluster: 8 CTAs portably, 16 with the non-portable
// opt-in (align/fullprob_fill.py::CLUSTER_MAX)
constexpr int CLUSTER_MAX = 16;

// lets a cluster build's CTA take smem bytes of dynamic shared memory
// beside its static rows of maxima: the default limit of 48 KB counts
// both, so the opt-in is set at any size
template <typename K>
cudaError_t allow_cluster_smem(K kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// the CTAs of this CTA's cluster
__device__ __forceinline__ int cluster_ctas() {
  return (int)cooperative_groups::this_cluster().num_blocks();
}

// the same address in the shared memory of CTA `rank` of the cluster
template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// the cluster barrier, in two halves: every thread of every CTA arrives
// (its shared and remote stores released at cluster scope), may do
// work that no peer reads, and waits (acquiring the others' stores).
// It also orders the CTA's own threads, as __syncthreads does.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// maximum over the cluster of the CTA maxima in row[0 .. C): every warp
// reduces the whole row itself. Max is exact, so the order of the
// reduction does not change the result.
__device__ __forceinline__ float cluster_row_max(const float* row, int C) {
  const int l = threadIdx.x & 31;
  float r = l < C ? row[l] : 0.0f;
  for (int o = 16; o > 0; o >>= 1)
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

// The CTA's maximum of v, stored into slot `rank` of row `row` of every
// CTA of the cluster (rem: this lane's CTA's row, lanes l < C). Each
// warp reduces its own with shuffles into wloc[warp] and arrives at
// named barrier 1; warp 0 waits there, reduces the nw warp maxima and
// its lanes l < C store the CTA's maximum into CTA l (C remote stores a
// CTA and diagonal, not C a warp). The cluster barrier that follows
// orders them; wloc is written again only after it.
__device__ __forceinline__ void cta_max_to_cluster(float v, float* wloc,
                                                   float* rem, int rank,
                                                   int C) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  if (l == 0) wloc[w] = v;
  if (w == 0) {
    asm volatile("bar.sync 1, %0;\n" ::"r"(nw * 32) : "memory");
    float m = l < nw ? wloc[l] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (l < C) rem[rank] = m;
  } else {
    asm volatile("bar.arrive 1, %0;\n" ::"r"(nw * 32) : "memory");
  }
}

// The launch configuration of B clusters of C CTAs (grid C B) of
// `threads` threads and smem bytes of dynamic shared memory.
struct ClusterConfig {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterConfig(int C, int B, int threads, size_t smem, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(C * B, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of C CTAs of `threads` threads and smem bytes of
// dynamic shared memory of `kernel` the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the error of the query.
// Past 8 CTAs it sets the non-portable opt-in first.
template <typename... P>
int cluster_fit(void (*kernel)(P...), int C, int threads, size_t smem) {
  if (C < 1 || C > CLUSTER_MAX) return -(int)cudaErrorInvalidValue;
  cudaError_t err = allow_cluster_smem(kernel, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int fit = 0;
  if (err == cudaSuccess) {
    const ClusterConfig c(C, 1, threads, smem, 0);
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &c.cfg);
  }
  if (err == cudaSuccess) return fit;
  cudaGetLastError();
  return -(int)err;
}

// Launches `kernel` on B clusters of C CTAs (2 to 16) of `threads`
// threads and smem bytes of dynamic shared memory, after asking the
// card whether one such cluster fits (cluster_fit): a cluster that
// cannot be scheduled is refused with cudaErrorLaunchOutOfResources,
// never launched. Returns the error, 0 on success.
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), int C, int B, int threads,
                   size_t smem, cudaStream_t st, A... args) {
  if (C < 2) return (int)cudaErrorInvalidValue;
  const int fit = cluster_fit(kernel, C, threads, smem);
  if (fit < 0) return -fit;
  if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
  const ClusterConfig c(C, B, threads, smem, st);
  const cudaError_t err = cudaLaunchKernelEx(&c.cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The fan-in builds of one kernel. KS names it: KS::Args is its
// argument struct (with H, G, KL, KR), KS::kernel<KLT, KRT, ROWS, ALLSH,
// MAXT>() its __global__ function; KLT, KRT the templated fan-in (0:
// runtime K), ROWS the lanes a thread (0: any count), ALLSH the whole
// ring in shared memory (H == G + 1), MAXT the largest block.
template <class KS, int KLT, int KRT, int ROWS, bool ALLSH, int MAXT>
int launch1(const typename KS::Args& a, int B, int threads, size_t smem,
            cudaStream_t st) {
  if (threads > MAXT) return (int)cudaErrorInvalidValue;
  const auto kernel = KS::template kernel<KLT, KRT, ROWS, ALLSH, MAXT>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <class KS, int KLT, int KRT, int ROWS, int MAXT>
int launch_ring(const typename KS::Args& a, int B, int threads, size_t smem,
                cudaStream_t st) {
  if (a.H == a.G + 1)
    return launch1<KS, KLT, KRT, ROWS, true, MAXT>(a, B, threads, smem, st);
  return launch1<KS, KLT, KRT, ROWS, false, MAXT>(a, B, threads, smem, st);
}

// The builds of one fan-in, each with the whole ring in shared memory
// or split: two lanes a thread in blocks of up to 768 threads (384 past
// a templated K 2 x 2, whose slot loops spilled registers at 512 in E);
// up to a templated K 2 x 2 also four lanes in blocks of up to 512 (on
// the H100 faster than the build for any count: E's 1.35-1.5x at 2,016
// and 2,048 lanes, D's 1.18-1.25x at 2,016).
template <class KS, int KLT, int KRT>
int launch_k(const typename KS::Args& a, int B, int rows, int threads,
             size_t smem, cudaStream_t st) {
  constexpr bool SMALL_K = KLT > 0 && KLT <= 2 && KRT <= 2;
  constexpr int MAXT2 = (KLT <= 2 && KRT <= 2) ? 768 : 384;
  if (rows == 2)
    return launch_ring<KS, KLT, KRT, 2, MAXT2>(a, B, threads, smem, st);
  if constexpr (SMALL_K) {
    if (rows == 4)
      return launch_ring<KS, KLT, KRT, 4, 512>(a, B, threads, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <class KS, int KLT>
int launch_kl(const typename KS::Args& a, int krt, int B, int rows,
              int threads, size_t smem, cudaStream_t st) {
  switch (krt) {
    case 1: return launch_k<KS, KLT, 1>(a, B, rows, threads, smem, st);
    case 2: return launch_k<KS, KLT, 2>(a, B, rows, threads, smem, st);
    case 3: return launch_k<KS, KLT, 3>(a, B, rows, threads, smem, st);
    case 4: return launch_k<KS, KLT, 4>(a, B, rows, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The build the plan names: (klt, krt) templated up to 4 x 4 (and
// equal to the call's fan-in), or (0, 0) runtime K with two lanes a
// thread or any count (rows 0, blocks of up to 1024). Any other plan
// is refused.
template <class KS>
int dispatch(const typename KS::Args& a, int klt, int krt, int B, int rows,
             int threads, size_t smem, cudaStream_t st) {
  if (klt == 0 && krt == 0) {
    if (rows == 0)
      return launch_ring<KS, 0, 0, 0, 1024>(a, B, threads, smem, st);
    return launch_k<KS, 0, 0>(a, B, rows, threads, smem, st);
  }
  if (klt != a.KL || krt != a.KR) return (int)cudaErrorInvalidValue;
  switch (klt) {
    case 1: return launch_kl<KS, 1>(a, krt, B, rows, threads, smem, st);
    case 2: return launch_kl<KS, 2>(a, krt, B, rows, threads, smem, st);
    case 3: return launch_kl<KS, 3>(a, krt, B, rows, threads, smem, st);
    case 4: return launch_kl<KS, 4>(a, krt, B, rows, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
