// Kernel E: scaled backward probability planes, anti-diagonals D-1 .. 0.
//
// Replaces the TPU kernel pagan2_tpu/align/fullprob_pallas.py::_bwd_kernel
// (launched by fullprob_bwd_pallas) with its linear entry point, and the
// XLA scan cores pagan2_tpu/align/fullprob.py::_build_bwd_fanin_gather
// and ::_build_bwd_fanin with its fan-in entry point. It writes row d of
// its outputs itself: no reversed input stream, no un-reversal.
//
// Per diagonal d, from the diagonals after it:
//   linear:  xn = bX(i+1, j) = x1[i+1], yn = bY(i, j+1) = y1[i],
//            T = q2[i+1], q = bM * ms2 of diagonal d+2 times 1/s of d+1
//            X = (ext xn + gcgo yn) + gcng T
//            Y = (ext yn + gcgo xn) + gcng T
//            M = (nggo xn + nggo yn) + ng2 T
//            M += seed at d = L + R - 2, lane L - 1 (true units: every
//            diagonal above the corner is 0, so cum is exactly 0 there)
//   fan-in:  A sums bX at (i+o, j) over the left site's FORWARD-edge
//            slots, B sums bY at (i, j+o) over the right site's, T sums
//            q = bM * msp at (i+oL, j+oR) times lw then rw over slot
//            pairs; X, Y, M as above from A, B, T; then
//            M += seed[L+R-2-d][i] * exp(-clip(cum)) for the seed rows.
//            A value of diagonal e is used in the units of diagonal d+1:
//            multiplied by 1/s of e-1, e-2, ..., d+1 in turn.
// Then invalid cells are zeroed, the maximum s over the diagonal is
// taken (1 where it is 0), the rows are multiplied by 1/s,
// q = M * ms2[d][i] (fan-in: M * msp[d][i]) and cum += log(s).
//
// Every operation is one IEEE f32 operation in the order written (build
// flag -fmad=false); sums over slots run in slot order. Layout, barriers
// and what bounds the kernel are as in fullprob_fwd.cu: one block per
// job, two block barriers a diagonal, the state (linear: X, Y, q of two
// generations and a row of raw M, 7 Lp floats; fan-in: a ring of G + 1
// generations of q, X, Y) in shared memory when it fits, else in a
// global scratch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// maximum of v over the block (v >= 0); holds one __syncthreads
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) red[w] = v;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  float r = (l < nw) ? red[l] : 0.0f;
  for (int o = 16; o > 0; o >>= 1)
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

template <bool SHARED>
__global__ void __launch_bounds__(1024) fullprob_bwd_linear_kernel(
    const float* __restrict__ ms2,     // (B, D, Lp), row d = diagonal d
    const float* __restrict__ consts,  // (B, 8): .. [5] corner seed
    const int* __restrict__ iscal,     // (B, 2): L R
    float* __restrict__ planes,        // (B, 3, D, Lp): M X Y
    float* __restrict__ cum,           // (B, D)
    float* gbuf,                       // (B, 7, Lp) when not SHARED
    int D, int Lp) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int b = blockIdx.x;
  // [parity 0..1][X, Y, q][Lp], then one row of raw M
  float* sh = SHARED ? smem : gbuf + (size_t)b * 7 * Lp;
  float* mraw = sh + 6 * Lp;
  const int nt = blockDim.x;
  const float ext = consts[b * 8 + 0];
  const float gcgo = consts[b * 8 + 1];
  const float nggo = consts[b * 8 + 2];
  const float ng2 = consts[b * 8 + 3];
  const float gcng = consts[b * 8 + 4];
  const float seed = consts[b * 8 + 5];
  const int L = iscal[b * 2 + 0];
  const int R = iscal[b * 2 + 1];
  const int cornerd = L + R - 2;
  const float* msb = ms2 + (size_t)b * D * Lp;
  float* pM = planes + ((size_t)b * 3 + 0) * D * Lp;
  float* pX = planes + ((size_t)b * 3 + 1) * D * Lp;
  float* pY = planes + ((size_t)b * 3 + 2) * D * Lp;
  float* cb = cum + (size_t)b * D;

  for (int i = threadIdx.x; i < Lp; i += nt)
    for (int q = 0; q < 7; ++q) sh[q * Lp + i] = 0.0f;
  float cumv = 0.0f;
  float invnext = 1.0f;    // 1/s of diagonal d+1
  __syncthreads();

  for (int d = D - 1; d >= 0; --d) {
    float* cur = sh + (d & 1) * 3 * Lp;          // X, Y of d; q of d+2
    const float* nxt = sh + ((d + 1) & 1) * 3 * Lp;   // X, Y, q of d+1
    const float* msd = msb + (size_t)d * Lp;
    float lmax = 0.0f;
    for (int i = threadIdx.x; i < Lp; i += nt) {
      const int j = d - i;
      float M = 0.0f, X = 0.0f, Y = 0.0f;
      if (j >= 0 && j < R && i < L) {
        float xn = 0.0f, T = 0.0f;
        if (i + 1 < Lp) {
          xn = nxt[i + 1];
          T = cur[2 * Lp + i + 1] * invnext;
        }
        const float yn = nxt[Lp + i];
        const float ex = ext * xn, ey = ext * yn;
        const float gx = gcgo * xn, gy = gcgo * yn;
        const float gt = gcng * T;
        X = (ex + gy) + gt;
        Y = (ey + gx) + gt;
        const float nx = nggo * xn, ny = nggo * yn;
        M = (nx + ny) + ng2 * T;
        if (d == cornerd && i == L - 1) M = M + seed;
      }
      cur[i] = X;
      cur[Lp + i] = Y;
      mraw[i] = M;
      lmax = fmaxf(lmax, fmaxf(fmaxf(M, X), Y));
    }
    float sc = block_max(lmax, red);
    if (!(sc > 0.0f)) sc = 1.0f;
    const float inv = 1.0f / sc;
    for (int i = threadIdx.x; i < Lp; i += nt) {
      const float M = mraw[i] * inv;
      const float X = cur[i] * inv;
      const float Y = cur[Lp + i] * inv;
      cur[i] = X;
      cur[Lp + i] = Y;
      cur[2 * Lp + i] = M * msd[i];
      pM[(size_t)d * Lp + i] = M;
      pX[(size_t)d * Lp + i] = X;
      pY[(size_t)d * Lp + i] = Y;
    }
    cumv = cumv + logf(sc);
    if (threadIdx.x == 0) cb[d] = cumv;
    invnext = inv;
    __syncthreads();
  }
}

// one matrix (mat 0 = q, 1 = X, 2 = Y) of diagonal e at lane `lane`, in
// the units of diagonal d+1
__device__ __forceinline__ float ring_read_bwd(
    const float* ring, const float* invh, int GR, int Lp, int mat, int e,
    int lane, int d) {
  float v = ring[((size_t)mat * GR + (e % GR)) * Lp + lane];
  int s = (e - 1) % GR;
  for (int t = e - 1; t > d; --t) {
    v = v * invh[s];
    s = (s == 0) ? GR - 1 : s - 1;
  }
  return v;
}

template <bool SHARED>
__global__ void __launch_bounds__(1024) fullprob_bwd_fanin_kernel(
    const float* __restrict__ msp,     // (B, D, Lp)
    const int* __restrict__ lfoff,     // (B, Lp, KL) forward-edge offsets
    const float* __restrict__ lfw,     // (B, Lp, KL)
    const int* __restrict__ rfoff,     // (B, Rr, KR)
    const float* __restrict__ rfw,     // (B, Rr, KR)
    const float* __restrict__ consts,  // (B, 8): .. [6] exp clip limit
    const int* __restrict__ iscal,     // (B, 2)
    const float* __restrict__ seed,    // (B, Gs, Lp)
    float* __restrict__ planes,        // (B, 3, D, Lp)
    float* __restrict__ cum,           // (B, D)
    float* gring,                      // (B, 3, G + 1, Lp) when not SHARED
    int D, int Lp, int Rr, int KL, int KR, int G, int Gs) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int GR = G + 1;
  // SHARED: [invh GR][ring q, X, Y][GR][Lp]; else the ring is global
  float* invh = smem;
  float* ring = SHARED ? smem + GR : gring + (size_t)b * 3 * GR * Lp;
  const size_t MS = (size_t)GR * Lp;
  const int nt = blockDim.x;
  const float ext = consts[b * 8 + 0];
  const float gcgo = consts[b * 8 + 1];
  const float nggo = consts[b * 8 + 2];
  const float ng2 = consts[b * 8 + 3];
  const float gcng = consts[b * 8 + 4];
  const float clim = consts[b * 8 + 6];
  const int L = iscal[b * 2 + 0];
  const int R = iscal[b * 2 + 1];
  const int cornerd = L + R - 2;
  const float* mb = msp + (size_t)b * D * Lp;
  const int* lo = lfoff + (size_t)b * Lp * KL;
  const float* lwb = lfw + (size_t)b * Lp * KL;
  const int* ro = rfoff + (size_t)b * Rr * KR;
  const float* rwb = rfw + (size_t)b * Rr * KR;
  const float* sb = seed + (size_t)b * Gs * Lp;
  float* pM = planes + ((size_t)b * 3 + 0) * D * Lp;
  float* pX = planes + ((size_t)b * 3 + 1) * D * Lp;
  float* pY = planes + ((size_t)b * 3 + 2) * D * Lp;
  float* cb = cum + (size_t)b * D;

  for (int i = threadIdx.x; i < Lp; i += nt)
    for (int q = 0; q < 3 * GR; ++q) ring[(size_t)q * Lp + i] = 0.0f;
  for (int g = threadIdx.x; g < GR; g += nt) invh[g] = 1.0f;
  float cumv = 0.0f;
  __syncthreads();

  for (int d = D - 1; d >= 0; --d) {
    // the slot of diagonal d last held diagonal d + G + 1, which no
    // offset reaches; its q row carries the raw M until it is scaled
    float* g0 = ring + (size_t)(d % GR) * Lp;
    const float* md = mb + (size_t)d * Lp;
    const int sidx = cornerd - d;
    const bool seeded = sidx >= 0 && sidx < Gs;
    const float unscale =
        seeded ? expf(-fminf(fmaxf(cumv, -clim), clim)) : 0.0f;
    float lmax = 0.0f;
    for (int i = threadIdx.x; i < Lp; i += nt) {
      const int j = d - i;
      float M = 0.0f, X = 0.0f, Y = 0.0f;
      if (j >= 0 && j < R && i < L) {
        float A = 0.0f, Bs = 0.0f, T = 0.0f;
        for (int k = 0; k < KL; ++k) {
          const int o = lo[i * KL + k];
          if (o > 0 && o <= G && i + o < Lp && d + o < D)
            A = A + ring_read_bwd(ring, invh, GR, Lp, 1, d + o, i + o, d);
        }
        for (int k = 0; k < KR; ++k) {
          const int o = ro[j * KR + k];
          if (o > 0 && o <= G && d + o < D)
            Bs = Bs + ring_read_bwd(ring, invh, GR, Lp, 2, d + o, i, d);
        }
        for (int kl = 0; kl < KL; ++kl) {
          const int ol = lo[i * KL + kl];
          if (!(ol > 0 && i + ol < Lp)) continue;
          const float wl = lwb[i * KL + kl];
          for (int kr = 0; kr < KR; ++kr) {
            const int orr = ro[j * KR + kr];
            const int ot = ol + orr;
            if (!(orr > 0 && ot <= G && d + ot < D)) continue;
            const float q =
                ring_read_bwd(ring, invh, GR, Lp, 0, d + ot, i + ol, d);
            T = T + (q * wl) * rwb[j * KR + kr];
          }
        }
        const float ea = ext * A, eb = ext * Bs;
        const float ga = gcgo * A, gb = gcgo * Bs;
        const float gt = gcng * T;
        X = (ea + gb) + gt;
        Y = (eb + ga) + gt;
        const float na = nggo * A, nb = nggo * Bs;
        M = (na + nb) + ng2 * T;
        if (seeded) M = M + sb[(size_t)sidx * Lp + i] * unscale;
      }
      g0[i] = M;
      g0[MS + i] = X;
      g0[2 * MS + i] = Y;
      lmax = fmaxf(lmax, fmaxf(fmaxf(M, X), Y));
    }
    float sc = block_max(lmax, red);
    if (!(sc > 0.0f)) sc = 1.0f;
    const float inv = 1.0f / sc;
    for (int i = threadIdx.x; i < Lp; i += nt) {
      const float M = g0[i] * inv;
      const float X = g0[MS + i] * inv;
      const float Y = g0[2 * MS + i] * inv;
      g0[i] = M * md[i];
      g0[MS + i] = X;
      g0[2 * MS + i] = Y;
      pM[(size_t)d * Lp + i] = M;
      pX[(size_t)d * Lp + i] = X;
      pY[(size_t)d * Lp + i] = Y;
    }
    cumv = cumv + logf(sc);
    if (threadIdx.x == 0) {
      cb[d] = cumv;
      invh[d % GR] = inv;
    }
    __syncthreads();
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int fullprob_bwd_linear_launch(
    const void* ms2, const void* consts, const void* iscal, void* planes,
    void* cum, void* gbuf, int B, int D, int Lp, int use_shared,
    int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!use_shared) {
    fullprob_bwd_linear_kernel<false><<<B, threads, 0, st>>>(
        (const float*)ms2, (const float*)consts, (const int*)iscal,
        (float*)planes, (float*)cum, (float*)gbuf, D, Lp);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)7 * Lp * sizeof(float);
  cudaError_t err = allow_smem(fullprob_bwd_linear_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  fullprob_bwd_linear_kernel<true><<<B, threads, smem, st>>>(
      (const float*)ms2, (const float*)consts, (const int*)iscal,
      (float*)planes, (float*)cum, (float*)gbuf, D, Lp);
  return (int)cudaGetLastError();
}

extern "C" int fullprob_bwd_fanin_launch(
    const void* msp, const void* lfoff, const void* lfw, const void* rfoff,
    const void* rfw, const void* consts, const void* iscal,
    const void* seed, void* planes, void* cum, void* gring, int B, int D,
    int Lp, int Rr, int KL, int KR, int G, int Gs, int use_shared,
    int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int GR = G + 1;
  if (!use_shared) {
    const size_t smem = (size_t)GR * sizeof(float);
    cudaError_t err = allow_smem(fullprob_bwd_fanin_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    fullprob_bwd_fanin_kernel<false><<<B, threads, smem, st>>>(
        (const float*)msp, (const int*)lfoff, (const float*)lfw,
        (const int*)rfoff, (const float*)rfw, (const float*)consts,
        (const int*)iscal, (const float*)seed, (float*)planes, (float*)cum,
        (float*)gring, D, Lp, Rr, KL, KR, G, Gs);
    return (int)cudaGetLastError();
  }
  const size_t smem = ((size_t)GR + (size_t)3 * GR * Lp) * sizeof(float);
  cudaError_t err = allow_smem(fullprob_bwd_fanin_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  fullprob_bwd_fanin_kernel<true><<<B, threads, smem, st>>>(
      (const float*)msp, (const int*)lfoff, (const float*)lfw,
      (const int*)rfoff, (const float*)rfw, (const float*)consts,
      (const int*)iscal, (const float*)seed, (float*)planes, (float*)cum,
      (float*)gring, D, Lp, Rr, KL, KR, G, Gs);
  return (int)cudaGetLastError();
}
