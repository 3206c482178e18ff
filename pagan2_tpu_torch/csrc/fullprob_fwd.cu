// Kernel D: scaled forward probability planes, one anti-diagonal a step.
//
// Replaces the TPU kernel pagan2_tpu/align/fullprob_pallas.py::_fwd_kernel
// (launched by fullprob_fwd_pallas) with its linear entry point, and the
// XLA scan cores pagan2_tpu/align/fullprob.py::_build_fwd_fanin_gather
// and ::_build_fwd_fanin with its fan-in entry point.
//
// Per diagonal d = i + j the three matrices are computed in probability
// space from earlier diagonals, the maximum s over the job's diagonal is
// taken (1 where it is 0), all three are multiplied by 1/s and
// cum[d] = cum[d-1] + log(s): a stored value times exp(cum[d]) is the
// true forward probability.
//
//   linear:  X(i,j) = (ext x1[i-1] + gcgo y1[i-1]) + nggo m1[i-1]
//            Y(i,j) = (ext y1[i]   + gcgo x1[i])   + nggo m1[i]
//            M(i,j) = ms2[d][i] ((ng2 m2[i-1] + gcng x2[i-1]) + gcng y2[i-1])
//   with (m1,x1,y1) diagonal d-1 and (m2,x2,y2) diagonal d-2 multiplied by
//   1/s of diagonal d-1, ms2 = (msp wl[i]) wr[j] folded by the caller.
//
//   fan-in:  X sums over the left site's backward-edge slots k with
//            offset o: the same combination read at diagonal d-o, lane
//            i-o, no weight; Y over the right site's slots at diagonal
//            d-o, lane i; M = msp[d][i] * sum over slot pairs (kl, kr) of
//            ((ng2 m + gcng x) + gcng y) at diagonal d-oL-oR, lane i-oL,
//            times lw then rw. A value of diagonal e is used in the units
//            of diagonal d-1: multiplied by 1/s of e+1, e+2, ..., d-1 in
//            turn, as a ring rescaled at every step would hold it.
//
// Every operation is one IEEE f32 operation in the order written (build
// flag -fmad=false), so the planes equal the plain PyTorch version's
// bit for bit. Sums over slots run in slot order.
//
// Layout: one block per job, threads stride over the lanes i. A step
// computes the raw diagonal into on-chip state, reduces its maximum
// (warp shuffles, one shared row, a barrier), scales its own lanes,
// writes them to the planes (B, 3, D, Lp) and ends in a second barrier.
// Linear: three generations of M/X/Y (9 Lp floats) in shared memory up to
// 4096 lanes, in a global scratch beyond. Fan-in: a ring of G + 1
// generations in shared memory when it fits, else in a global scratch
// that stays in L2. What bounds it on an H100 is the serial chain of
// D dependent diagonals with two block barriers each, not bytes (16 B a
// cell) or operations.
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
__global__ void __launch_bounds__(1024) fullprob_fwd_linear_kernel(
    const float* __restrict__ ms2,     // (B, D, Lp), row d = diagonal d
    const float* __restrict__ consts,  // (B, 8)
    const int* __restrict__ iscal,     // (B, 2): L R
    float* __restrict__ planes,        // (B, 3, D, Lp): M X Y
    float* __restrict__ cum,           // (B, D)
    float* gbuf,                       // (B, 9, Lp) when not SHARED
    int D, int Lp) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int b = blockIdx.x;
  // [generation 0..2][M, X, Y][Lp]
  float* sh = SHARED ? smem : gbuf + (size_t)b * 9 * Lp;
  const int nt = blockDim.x;
  const float ext = consts[b * 8 + 0];
  const float gcgo = consts[b * 8 + 1];
  const float nggo = consts[b * 8 + 2];
  const float ng2 = consts[b * 8 + 3];
  const float gcng = consts[b * 8 + 4];
  const int L = iscal[b * 2 + 0];
  const int R = iscal[b * 2 + 1];
  const float* msb = ms2 + (size_t)b * D * Lp;
  float* pM = planes + ((size_t)b * 3 + 0) * D * Lp;
  float* pX = planes + ((size_t)b * 3 + 1) * D * Lp;
  float* pY = planes + ((size_t)b * 3 + 2) * D * Lp;
  float* cb = cum + (size_t)b * D;

  // diagonal 0 in generation 0: M(0, 0) = 1, all else 0
  for (int i = threadIdx.x; i < Lp; i += nt) {
    for (int q = 0; q < 9; ++q) sh[q * Lp + i] = 0.0f;
    if (i == 0) sh[0] = 1.0f;
    pM[i] = (i == 0) ? 1.0f : 0.0f;
    pX[i] = 0.0f;
    pY[i] = 0.0f;
  }
  if (threadIdx.x == 0) cb[0] = 0.0f;
  float cumv = 0.0f;
  float invprev = 1.0f;    // 1/s of diagonal d-1
  __syncthreads();

  for (int d = 1; d < D; ++d) {
    const float* g1 = sh + ((d - 1) % 3) * 3 * Lp;   // diagonal d-1
    const float* g2 = sh + ((d + 1) % 3) * 3 * Lp;   // diagonal d-2
    float* g0 = sh + (d % 3) * 3 * Lp;               // diagonal d
    const float* msd = msb + (size_t)d * Lp;
    float lmax = 0.0f;
    for (int i = threadIdx.x; i < Lp; i += nt) {
      const int j = d - i;
      float M = 0.0f, X = 0.0f, Y = 0.0f;
      if (j >= 0 && j < R && i < L) {
        if (i > 0) {
          const float a = ext * g1[Lp + i - 1];
          const float c = gcgo * g1[2 * Lp + i - 1];
          const float e = nggo * g1[i - 1];
          X = (a + c) + e;
        }
        if (j > 0) {
          const float a = ext * g1[2 * Lp + i];
          const float c = gcgo * g1[Lp + i];
          const float e = nggo * g1[i];
          Y = (a + c) + e;
        }
        if (i > 0 && j > 0) {
          const float m2 = g2[i - 1] * invprev;
          const float x2 = g2[Lp + i - 1] * invprev;
          const float y2 = g2[2 * Lp + i - 1] * invprev;
          const float a = ng2 * m2;
          const float c = gcng * x2;
          const float e = gcng * y2;
          M = msd[i] * ((a + c) + e);
        }
      }
      g0[i] = M;
      g0[Lp + i] = X;
      g0[2 * Lp + i] = Y;
      lmax = fmaxf(lmax, fmaxf(fmaxf(M, X), Y));
    }
    float sc = block_max(lmax, red);
    if (!(sc > 0.0f)) sc = 1.0f;
    const float inv = 1.0f / sc;
    for (int i = threadIdx.x; i < Lp; i += nt) {
      const float M = g0[i] * inv;
      const float X = g0[Lp + i] * inv;
      const float Y = g0[2 * Lp + i] * inv;
      g0[i] = M;
      g0[Lp + i] = X;
      g0[2 * Lp + i] = Y;
      pM[(size_t)d * Lp + i] = M;
      pX[(size_t)d * Lp + i] = X;
      pY[(size_t)d * Lp + i] = Y;
    }
    cumv = cumv + logf(sc);
    if (threadIdx.x == 0) cb[d] = cumv;
    invprev = inv;
    __syncthreads();
  }
}

// (M, X, Y) of diagonal e at lane `lane`, in the units of diagonal d-1
__device__ __forceinline__ void ring_read_fwd(
    const float* ring, const float* invh, int GR, int Lp, int e, int lane,
    int d, float& m, float& x, float& y) {
  const float* row = ring + (size_t)(e % GR) * Lp + lane;
  m = row[0];
  x = row[(size_t)GR * Lp];
  y = row[(size_t)2 * GR * Lp];
  int s = (e + 1) % GR;
  for (int t = e + 1; t < d; ++t) {
    const float f = invh[s];
    m = m * f;
    x = x * f;
    y = y * f;
    s = (s + 1 == GR) ? 0 : s + 1;
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(1024) fullprob_fwd_fanin_kernel(
    const float* __restrict__ msp,     // (B, D, Lp)
    const int* __restrict__ loff,      // (B, Lp, KL)
    const float* __restrict__ lw,      // (B, Lp, KL)
    const int* __restrict__ roff,      // (B, Rr, KR)
    const float* __restrict__ rw,      // (B, Rr, KR)
    const float* __restrict__ consts,  // (B, 8)
    const int* __restrict__ iscal,     // (B, 2)
    float* __restrict__ planes,        // (B, 3, D, Lp)
    float* __restrict__ cum,           // (B, D)
    float* gring,                      // (B, 3, G + 1, Lp) when not SHARED
    int D, int Lp, int Rr, int KL, int KR, int G) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int GR = G + 1;
  // SHARED: [invh GR][ring 3][GR][Lp]; else invh in smem, ring global
  float* invh = smem;
  float* ring = SHARED ? smem + GR : gring + (size_t)b * 3 * GR * Lp;
  const size_t MS = (size_t)GR * Lp;   // matrix stride in the ring
  const int nt = blockDim.x;
  const float ext = consts[b * 8 + 0];
  const float gcgo = consts[b * 8 + 1];
  const float nggo = consts[b * 8 + 2];
  const float ng2 = consts[b * 8 + 3];
  const float gcng = consts[b * 8 + 4];
  const int L = iscal[b * 2 + 0];
  const int R = iscal[b * 2 + 1];
  const float* mb = msp + (size_t)b * D * Lp;
  const int* lo = loff + (size_t)b * Lp * KL;
  const float* lwb = lw + (size_t)b * Lp * KL;
  const int* ro = roff + (size_t)b * Rr * KR;
  const float* rwb = rw + (size_t)b * Rr * KR;
  float* pM = planes + ((size_t)b * 3 + 0) * D * Lp;
  float* pX = planes + ((size_t)b * 3 + 1) * D * Lp;
  float* pY = planes + ((size_t)b * 3 + 2) * D * Lp;
  float* cb = cum + (size_t)b * D;

  for (int i = threadIdx.x; i < Lp; i += nt) {
    for (int q = 0; q < 3 * GR; ++q) ring[(size_t)q * Lp + i] = 0.0f;
    if (i == 0) ring[0] = 1.0f;
    pM[i] = (i == 0) ? 1.0f : 0.0f;
    pX[i] = 0.0f;
    pY[i] = 0.0f;
  }
  for (int g = threadIdx.x; g < GR; g += nt) invh[g] = 1.0f;
  if (threadIdx.x == 0) cb[0] = 0.0f;
  float cumv = 0.0f;
  __syncthreads();

  for (int d = 1; d < D; ++d) {
    float* g0 = ring + (size_t)(d % GR) * Lp;
    const float* md = mb + (size_t)d * Lp;
    float lmax = 0.0f;
    for (int i = threadIdx.x; i < Lp; i += nt) {
      const int j = d - i;
      float M = 0.0f, X = 0.0f, Y = 0.0f;
      if (j >= 0 && j < R && i < L) {
        float m, x, y;
        if (i > 0) {
          float acc = 0.0f;
          for (int k = 0; k < KL; ++k) {
            const int o = lo[i * KL + k];
            if (o > 0 && o <= G && i - o >= 0 && d - o >= 0) {
              ring_read_fwd(ring, invh, GR, Lp, d - o, i - o, d, m, x, y);
              const float a = ext * x;
              const float c = gcgo * y;
              const float e = nggo * m;
              acc = acc + ((a + c) + e);
            }
          }
          X = acc;
        }
        if (j > 0) {
          float acc = 0.0f;
          for (int k = 0; k < KR; ++k) {
            const int o = ro[j * KR + k];
            if (o > 0 && o <= G && d - o >= 0) {
              ring_read_fwd(ring, invh, GR, Lp, d - o, i, d, m, x, y);
              const float a = ext * y;
              const float c = gcgo * x;
              const float e = nggo * m;
              acc = acc + ((a + c) + e);
            }
          }
          Y = acc;
        }
        if (i > 0 && j > 0) {
          float acc = 0.0f;
          for (int kl = 0; kl < KL; ++kl) {
            const int ol = lo[i * KL + kl];
            if (!(ol > 0 && i - ol >= 0)) continue;
            const float wl = lwb[i * KL + kl];
            for (int kr = 0; kr < KR; ++kr) {
              const int orr = ro[j * KR + kr];
              const int ot = ol + orr;
              if (!(orr > 0 && ot <= G && d - ot >= 0)) continue;
              ring_read_fwd(ring, invh, GR, Lp, d - ot, i - ol, d, m, x, y);
              const float a = ng2 * m;
              const float c = gcng * x;
              const float e = gcng * y;
              const float combo = (a + c) + e;
              acc = acc + (combo * wl) * rwb[j * KR + kr];
            }
          }
          M = md[i] * acc;
        }
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
      g0[i] = M;
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

extern "C" int fullprob_fwd_linear_launch(
    const void* ms2, const void* consts, const void* iscal, void* planes,
    void* cum, void* gbuf, int B, int D, int Lp, int use_shared,
    int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!use_shared) {
    fullprob_fwd_linear_kernel<false><<<B, threads, 0, st>>>(
        (const float*)ms2, (const float*)consts, (const int*)iscal,
        (float*)planes, (float*)cum, (float*)gbuf, D, Lp);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)9 * Lp * sizeof(float);
  cudaError_t err = allow_smem(fullprob_fwd_linear_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  fullprob_fwd_linear_kernel<true><<<B, threads, smem, st>>>(
      (const float*)ms2, (const float*)consts, (const int*)iscal,
      (float*)planes, (float*)cum, (float*)gbuf, D, Lp);
  return (int)cudaGetLastError();
}

extern "C" int fullprob_fwd_fanin_launch(
    const void* msp, const void* loff, const void* lw, const void* roff,
    const void* rw, const void* consts, const void* iscal,
    const void* seed, void* planes, void* cum, void* gring, int B, int D,
    int Lp, int Rr, int KL, int KR, int G, int Gs, int use_shared,
    int threads, void* stream) {
  (void)seed;
  (void)Gs;
  cudaStream_t st = (cudaStream_t)stream;
  const int GR = G + 1;
  if (!use_shared) {
    const size_t smem = (size_t)GR * sizeof(float);
    cudaError_t err = allow_smem(fullprob_fwd_fanin_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    fullprob_fwd_fanin_kernel<false><<<B, threads, smem, st>>>(
        (const float*)msp, (const int*)loff, (const float*)lw,
        (const int*)roff, (const float*)rw, (const float*)consts,
        (const int*)iscal, (float*)planes, (float*)cum, (float*)gring, D,
        Lp, Rr, KL, KR, G);
    return (int)cudaGetLastError();
  }
  const size_t smem = ((size_t)GR + (size_t)3 * GR * Lp) * sizeof(float);
  cudaError_t err = allow_smem(fullprob_fwd_fanin_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  fullprob_fwd_fanin_kernel<true><<<B, threads, smem, st>>>(
      (const float*)msp, (const int*)loff, (const float*)lw,
      (const int*)roff, (const float*)rw, (const float*)consts,
      (const int*)iscal, (float*)planes, (float*)cum, (float*)gring, D, Lp,
      Rr, KL, KR, G);
  return (int)cudaGetLastError();
}
