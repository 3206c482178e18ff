// What kernels D and E (fullprob_fwd.cu, fullprob_bwd.cu) share: the
// maxima of their one block barrier a diagonal, and the launch of the
// fan-in build that a launch plan names (align/fullprob_fill.py::
// fwd_fanin_plan, ::bwd_fanin_plan).
#pragma once
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
