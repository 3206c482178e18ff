// Kernel F: ablation variants of the linear-chain Viterbi step.
//
// Replaces the two measuring kernels of the JAX package's tools:
//   tools/_probe_pallas.py::_kernel      (entry point viterbi_probe_launch)
//   tools/_bisect_pallas.py::make_kernel (entry point viterbi_bisect_launch)
// Both are kernel 1's step (pagan2_tpu/align/viterbi_pallas.py::_kernel)
// with parts switched off at compile time, so that the cost of one
// diagonal can be split into its parts: the match-score read (NOMS), the
// code store (NOBP), the validity masks (NOMASK), the corner capture
// (NOCORNER) and the neighbour read of row i - 1 (NOROLL). What is left
// when all are off is the barrier and the recurrence chain.
//
// Semantics are the JAX variants', not kernel A's:
//   - one lower bound vlo per row: valid = vlo <= j <= vhi, X also needs
//     i > 0, Y and M also need j > 0;
//   - the corner output is the whole row of diagonal cornerd, (B, Lp) for
//     each of M, X, Y, NEG where that diagonal never comes;
//   - one code byte per cell at the target cell, bm | bx << 2 | by << 4;
//   - the X and M candidates are formed at the source row s = i - 1 and
//     moved to row i, as the TPU kernel's lane roll moves them. The roll
//     is circular: row 0 takes row Lp - 1 of the earlier diagonals, its
//     j-dependent selects and its code bits. With the masks on, row 0's X
//     and M are masked anyway; with them off (NOMASK) the values show.
//   - ms row r, codes row r are diagonal r + 1 (the TPU layout, (Dpk, B,
//     Lp)); every one of the Dpk diagonals is computed, padding included.
// Per-flag differences between the two tools: the probe's NOBP stores no
// code at all (its buffer stays undefined, as on the TPU); the bisect's NOBP
// stores a 0 byte per cell. The bisect's NOMASK also drops the gj / orp
// selects (gj = gext, orp = lgo). The bisect always captures the corner;
// its NEG is -1e30 (passed in by the wrapper), the probe's -inf.
//
// Layout: kernel A's (csrc/viterbi_linear.cu): one block per job, threads
// stride over the rows i, the three diagonals of M/X/Y in dynamic shared
// memory up to Lp = 4096 (144 KB) and in a global scratch beyond, one
// __syncthreads per diagonal.
//
// What bounds it on an H100: the same serial chain of Dpk dependent
// diagonals as kernel A, each ending in a block barrier, B blocks on 132
// SMs; the bytes (up to 4 B read and 1 B written a cell) and operations
// are far below the card's rates. It exists to measure that chain, not to
// be fast.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

enum : int {
  NOBP = 1,       // no code computed or stored (bisect: a 0 byte stored)
  NOMS = 2,       // no match-score read (adds 0)
  NOMASK = 4,     // no validity masks (bisect: no gj / orp selects either)
  NOCORNER = 8,   // no capture of the corner diagonal
  NOROLL = 16,    // X and M from row i, not i - 1
  BISECT = 32,    // the bisect tool's semantics (see the header)
};

// 1024 threads a block: the bound keeps every flag set at 64 registers
// or fewer (nocorner needed 66 without it and could not launch)
template <int FLAGS, bool SHARED>
__global__ void __launch_bounds__(1024) viterbi_probe_kernel(
    const float* __restrict__ fscal,   // (B, 8): gext gend lgo lng orp0
    const int* __restrict__ iscal,     // (B, 8): R cornerd
    const float* __restrict__ gexti,   // (B, Lp)
    const float* __restrict__ ol,      // (B, Lp)
    const int* __restrict__ vlo,       // (B, Lp)
    const int* __restrict__ vhi,       // (B, Lp)
    const float* __restrict__ ms,      // (Dpk, B, Lp), row r = diag r + 1
    int8_t* __restrict__ bp,           // (Dpk, B, Lp)
    float* __restrict__ fM,            // (B, Lp)
    float* __restrict__ fX,
    float* __restrict__ fY,
    float* __restrict__ gbuf,          // (B, 9, Lp) when not SHARED
    float NEG, int B, int Dpk, int Lp) {
  constexpr bool bisect = (FLAGS & BISECT) != 0;
  constexpr bool codes = (FLAGS & NOBP) == 0;
  constexpr bool store = codes || bisect;
  constexpr bool readms = (FLAGS & NOMS) == 0;
  constexpr bool masks = (FLAGS & NOMASK) == 0;
  constexpr bool selects = masks || !bisect;
  constexpr bool corner = (FLAGS & NOCORNER) == 0;
  constexpr bool roll = (FLAGS & NOROLL) == 0;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  // [gen 0..2][mat M,X,Y][Lp]
  float* sh = SHARED ? smem : gbuf + (size_t)b * 9 * Lp;
  const int nt = blockDim.x;
  const float gext = fscal[b * 8 + 0];
  const float gend = fscal[b * 8 + 1];
  const float lgo = fscal[b * 8 + 2];
  const float lng = fscal[b * 8 + 3];
  const float orp0 = fscal[b * 8 + 4];
  const int Rdp = iscal[b * 8 + 0];
  const int cornerd = iscal[b * 8 + 1];
  const size_t rowoff = (size_t)b * Lp;

  // diagonal 0 in slot 0: M(0, 0) = 0, all else NEG; slots 1 and 2
  // (diagonals -2 and -1) all NEG
  for (int i = threadIdx.x; i < Lp; i += nt) {
    for (int q = 0; q < 9; ++q) sh[q * Lp + i] = NEG;
    if (i == 0) sh[0] = 0.0f;
    fM[rowoff + i] = NEG;
    fX[rowoff + i] = NEG;
    fY[rowoff + i] = NEG;
  }
  __syncthreads();

  for (int d = 1; d <= Dpk; ++d) {
    const float* g1 = sh + ((d - 1) % 3) * 3 * Lp;   // diagonal d-1
    const float* g2 = sh + ((d + 1) % 3) * 3 * Lp;   // diagonal d-2
    float* g0 = sh + (d % 3) * 3 * Lp;               // diagonal d
    const size_t out = ((size_t)(d - 1) * B + b) * Lp;
    for (int i = threadIdx.x; i < Lp; i += nt) {
      // source row of the X and M candidates (the lane roll's source)
      const int s = roll ? (i > 0 ? i - 1 : Lp - 1) : i;
      // X: ext, double, open, formed at row s
      const int js = (d - 1) - s;
      const float gj =
          selects ? ((js == 0 || js == Rdp - 1) ? gend : gext) : gext;
      const float m1s = g1[s], x1s = g1[Lp + s], y1s = g1[2 * Lp + s];
      const float cx0 = x1s + gj;
      const float cx1 = y1s + lgo;
      const float cx2 = (m1s + lng) + ol[rowoff + s];
      const float v01 = fmaxf(cx0, cx1);
      const float xc = fmaxf(v01, cx2);
      // Y: ext, double, open, at row i
      const int ji = (d - 1) - i;
      const float orp = selects ? (ji == 0 ? orp0 : lgo) : lgo;
      const float m1 = g1[i], x1 = g1[Lp + i], y1 = g1[2 * Lp + i];
      const float cy0 = y1 + gexti[rowoff + i];
      const float cy1 = x1 + lgo;
      const float cy2 = (m1 + lng) + orp;
      const float w01 = fmaxf(cy0, cy1);
      const float yc = fmaxf(w01, cy2);
      // M: m, x, y of diagonal d-2 at row s
      const float m2s = g2[s], x2s = g2[Lp + s], y2s = g2[2 * Lp + s];
      const float t2 = m2s + lng;
      const float u01 = fmaxf(t2, x2s);
      const float mc = fmaxf(u01, y2s);
      const float msv = readms ? ms[out + i] : 0.0f;

      float X, Y, M;
      if (masks) {
        const int jt = d - i;
        const bool valid = jt >= vlo[rowoff + i] && jt <= vhi[rowoff + i];
        const bool okx = valid && i > 0;
        const bool oky = valid && jt > 0;
        const bool okm = okx && jt > 0;
        X = okx ? xc : NEG;
        Y = oky ? yc : NEG;
        M = okm ? mc + msv : NEG;
      } else {
        X = xc;
        Y = yc;
        M = mc + msv;
      }
      g0[i] = M;
      g0[Lp + i] = X;
      g0[2 * Lp + i] = Y;
      if (store) {
        int code = 0;
        if (codes) {
          const int bx = (cx2 > v01) ? 2 : ((cx1 > cx0) ? 1 : 0);
          const int by = (cy2 > w01) ? 2 : ((cy1 > cy0) ? 1 : 0);
          const int bm = (y2s > u01) ? 2 : ((x2s > t2) ? 1 : 0);
          code = bm | (bx << 2) | (by << 4);
        }
        bp[out + i] = (int8_t)code;
      }
      if (corner && d == cornerd) {
        fM[rowoff + i] = M;
        fX[rowoff + i] = X;
        fY[rowoff + i] = Y;
      }
    }
    __syncthreads();
  }
}

template <int FLAGS>
int launch(const void* fscal, const void* iscal, const void* gexti,
           const void* ol, const void* vlo, const void* vhi, const void* ms,
           void* bp, void* fM, void* fX, void* fY, void* gbuf, float neg,
           int B, int Dpk, int Lp, int use_shared, int threads,
           cudaStream_t st) {
  if (!use_shared) {
    viterbi_probe_kernel<FLAGS, false><<<B, threads, 0, st>>>(
        (const float*)fscal, (const int*)iscal, (const float*)gexti,
        (const float*)ol, (const int*)vlo, (const int*)vhi,
        (const float*)ms, (int8_t*)bp, (float*)fM, (float*)fX, (float*)fY,
        (float*)gbuf, neg, B, Dpk, Lp);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)9 * Lp * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_probe_kernel<FLAGS, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_probe_kernel<FLAGS, true><<<B, threads, smem, st>>>(
      (const float*)fscal, (const int*)iscal, (const float*)gexti,
      (const float*)ol, (const int*)vlo, (const int*)vhi, (const float*)ms,
      (int8_t*)bp, (float*)fM, (float*)fX, (float*)fY, (float*)gbuf, neg,
      B, Dpk, Lp);
  return (int)cudaGetLastError();
}

// returned for a flag set that has no instantiation
constexpr int UNKNOWN_FLAGS = -1;

}  // namespace

#define PROBE_ARGS                                                        \
  fscal, iscal, gexti, ol, vlo, vhi, ms, bp, fM, fX, fY, gbuf, neg, B,    \
      Dpk, Lp, use_shared, threads, (cudaStream_t)stream

// The probe's flag sets (tools/_probe_pallas.py's cases): base, nobp,
// noms, nomask, nocorner, nobp+noms, all-off.
extern "C" int viterbi_probe_launch(
    const void* fscal, const void* iscal, const void* gexti, const void* ol,
    const void* vlo, const void* vhi, const void* ms, void* bp, void* fM,
    void* fX, void* fY, void* gbuf, float neg, int B, int Dpk, int Lp,
    int use_shared, int threads, int flags, void* stream) {
  switch (flags) {
    case 0: return launch<0>(PROBE_ARGS);
    case NOBP: return launch<NOBP>(PROBE_ARGS);
    case NOMS: return launch<NOMS>(PROBE_ARGS);
    case NOMASK: return launch<NOMASK>(PROBE_ARGS);
    case NOCORNER: return launch<NOCORNER>(PROBE_ARGS);
    case NOBP | NOMS: return launch<NOBP | NOMS>(PROBE_ARGS);
    case NOBP | NOMS | NOMASK | NOCORNER:
      return launch<NOBP | NOMS | NOMASK | NOCORNER>(PROBE_ARGS);
    default: return UNKNOWN_FLAGS;
  }
}

// The bisect's variants (tools/_bisect_pallas.py's runs): full, nobp,
// noroll, nomask, nobp+noroll, nobp+noroll+nomask. `flags` holds the
// NOBP / NOMASK / NOROLL bits; BISECT is added here.
extern "C" int viterbi_bisect_launch(
    const void* fscal, const void* iscal, const void* gexti, const void* ol,
    const void* vlo, const void* vhi, const void* ms, void* bp, void* fM,
    void* fX, void* fY, void* gbuf, float neg, int B, int Dpk, int Lp,
    int use_shared, int threads, int flags, void* stream) {
  switch (flags) {
    case 0: return launch<BISECT>(PROBE_ARGS);
    case NOBP: return launch<BISECT | NOBP>(PROBE_ARGS);
    case NOROLL: return launch<BISECT | NOROLL>(PROBE_ARGS);
    case NOMASK: return launch<BISECT | NOMASK>(PROBE_ARGS);
    case NOBP | NOROLL: return launch<BISECT | NOBP | NOROLL>(PROBE_ARGS);
    case NOBP | NOROLL | NOMASK:
      return launch<BISECT | NOBP | NOROLL | NOMASK>(PROBE_ARGS);
    default: return UNKNOWN_FLAGS;
  }
}
