// Kernel A: linear-chain 3-state (M/X/Y) Viterbi wavefront.
//
// Replaces the TPU kernel pagan2_tpu/align/viterbi_pallas.py::_kernel
// (launched by pallas_fill). Same recurrence, candidate order, strict
// first-wins updates and f32 add order:
//   X at (i, j) from (i-1, j):  ext x + gj, double y + lgo,
//                               open (m + lng) + ol[i-1]
//   Y at (i, j) from (i, j-1):  ext y + gexti[i], double x + lgo,
//                               open (m + lng) + orp
//   M at (i, j) from (i-1, j-1): max(m + lng, x, y) + ms_folded[d][i]
// where the match score was pre-folded on the host side as
// ((ms + lw[i]) + rw[j]) + lng. Codes are plain bytes written at the
// TARGET cell: bm bits 0-1, bx 2-3, by 4-5 (the Pallas kernel's packed
// f32 words and its source-lane roll do not exist here).
//
// What bounds it on an H100: not bytes (5 B/cell against 3.35 TB/s) and
// not operations (~30 f32 compare/add/select per cell against 67
// TFLOP/s) but the serial chain of D = L + R - 1 dependent diagonals,
// each ending in a block-wide barrier, with only B blocks (one per job)
// on 132 SMs. So a step costs its barrier, the latency of its chain and
// the cycles its instructions take to dispatch, and the design cuts all
// three.
//
// The lane builds (ROWS = 1, 2 or 4 rows a thread, up to 4096 rows):
//  1. A thread owns ROWS consecutive rows i0 .. i0 + ROWS - 1 (i0 = tid
//     * ROWS). Their M, X, Y of diagonal d-1 stay in registers from one
//     step to the next. Row i-1 of the thread's first row is the last
//     row of the thread below: by __shfl_up_sync inside a warp, and
//     across warps from a shared row of warp-edge values (the last
//     row's M, X, Y of each warp, two rows taken in turn by the parity
//     of d). So a step needs one __syncthreads. (On the H100 a handoff
//     from warp to warp by flags in shared memory, and a split-phase
//     mbarrier that let a warp finish its step past the barrier, both
//     kept the outputs but took 1.7-5x longer a step than the barrier.)
//  2. M at (i, j) reads only diagonal d-2 at row i-1: the values that X
//     read at step d-1. So step d-1 takes M's maximum and its code for
//     step d (mc, bm) right after X's, and no value of d-2 is kept.
//  3. The per-row inputs (gexti[i], ol[i-1] and the validity bounds,
//     shifted into bounds on jb = d - i0) are loaded once a launch.
//     jb moves by one a step; the j-dependent selects (gj, orp) and the
//     masks compare jb with per-row constants: no device-memory load
//     is left on the step but the match score, and no division.
//  4. The match score of diagonal d+1 (and of d+2 with one row a
//     thread, whose short step does not hide one load) is loaded (one
//     4, 8 or 16-byte load a thread and diagonal) while step d runs.
//     The codes of a thread's rows are built in place in one word from
//     pre-shifted constants and leave in one 1, 2 or 4-byte store,
//     coalesced over the warp.
//  5. Out-of-matrix warps are skipped, exactly: a cell whose three
//     sources (i-1, j), (i, j-1), (i-1, j-1) all lie outside the
//     matrix (j >= R+1, j <= -1 or i >= L+1) has every candidate at
//     -inf, so code 0 and M, X, Y -inf in the plain version too. A warp
//     whose rows wlo .. whi all lie there on diagonal d (d outside
//     [wlo, min(whi, L) + R], or wlo > L) stores code 0 and sets its
//     lanes to -inf without computing. This rests on the prep's bounds:
//     rows >= L and columns >= R never valid, vlox and vloy >= 0
//     (linear_job_arrays).
//  6. The corner capture is tested once a diagonal, in the thread that
//     owns row L-1.
// The global build (ROWS 0, past 4096 rows or a row count that is not a
// whole number of warps): one block per job, threads strided over the
// rows, M/X/Y of the last three diagonals (9 * Lp * 4 bytes) in a
// global scratch resident in the 50 MB L2.
//
// The pair-end builds (PE, a template flag of every build) are the
// reference's pair-end Viterbi fill, which is its scan core
// (viterbi_sheared.py:450-455), not its Pallas kernel:
//  - a job whose right side is a pair-end read has one column jbrk
//    (iscal[2], -1 for none) whose X extension is gbrk (fscal[5]) and
//    whose Y open into column jbrk + 1 is obrk (fscal[6]), in place of
//    gext/gend and orp0/lgo: prepare_sheared writes the break after the
//    terminal values, so it wins at j = 0 and j = R - 1;
//  - M's three candidates are compared after the match score is added
//    (first wins on a tie), as the scan core takes its argmax; the host
//    folds that score in the scan core's order, ((lng + ms) + lw) + rw.
//    Comparing before the add, as the ordinary builds do, picks another
//    code where two candidates differ by less than the add rounds away.
// A launch of pair-end jobs (iscal[3] = 1) takes the PE build, any
// other launch the ordinary build, whose step is the step it was before
// the flag existed.
//
// The launch plan (rows a thread, threads) is align/viterbi_linear.py::
// linear_plan; the kernel only takes a plan it has a build for and
// refuses any other.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// a + b clamped to INT_MAX (b >= 0): a row's bound on j shifted into a
// bound on jb = j + k keeps its meaning for every jb a launch reaches
__device__ __forceinline__ int add_sat(int a, int b) {
  return a > 0x7fffffff - b ? 0x7fffffff : a + b;
}

template <int ROWS> struct Vec;
template <> struct Vec<1> {
  typedef float F;
  typedef uint8_t C;
};
template <> struct Vec<2> {
  typedef float2 F;
  typedef uint16_t C;
};
template <> struct Vec<4> {
  typedef float4 F;
  typedef uint32_t C;
};

template <int ROWS>
__device__ __forceinline__ void load_rows(float (&v)[ROWS], const float* p) {
  const typename Vec<ROWS>::F t =
      __ldg(reinterpret_cast<const typename Vec<ROWS>::F*>(p));
  const float* f = reinterpret_cast<const float*>(&t);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) v[k] = f[k];
}

// jbrk of a job with no break column: j - jbrk and j - 1 - jbrk never
// reach 0 for a j a launch meets
constexpr int NO_BREAK = -0x40000000;

template <int ROWS, bool PE>
__global__ void __launch_bounds__(1024) viterbi_linear_lanes_kernel(
    const float* __restrict__ ms,      // (B, D, Lp) folded, row d = diag d
    const float* __restrict__ gexti,   // (B, Lp)
    const float* __restrict__ ol,      // (B, Lp)
    const int* __restrict__ vlox,      // (B, Lp)
    const int* __restrict__ vloy,      // (B, Lp)
    const int* __restrict__ vhi,       // (B, Lp)
    const float* __restrict__ fscal,   // (B, 8): gext gend lgo lng orp0
                                       //         gbrk obrk
    const int* __restrict__ iscal,     // (B, 8): L R jbrk pair-end
    uint8_t* __restrict__ codes,       // (B, D, Lp)
    float* __restrict__ corner,        // (B, 3)
    int D, int Lp) {
  typedef typename Vec<ROWS>::C Code;
  // diagonals of match scores loaded ahead: two for one row a thread
  // (whose short step does not hide one load), one for two and four
  constexpr int AHEAD = ROWS == 1 ? 2 : 1;
  // last row's M, X, Y of each warp, by the parity of its diagonal
  __shared__ float4 edge[2][32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const float NEG = -CUDART_INF_F;
  const float gext = fscal[b * 8 + 0];
  const float gend = fscal[b * 8 + 1];
  const float lgo = fscal[b * 8 + 2];
  const float lng = fscal[b * 8 + 3];
  const float orp0 = fscal[b * 8 + 4];
  const int L = iscal[b * 8 + 0];
  const int R = iscal[b * 8 + 1];
  float gbrk = 0.0f, obrk = 0.0f;
  int jbrk = NO_BREAK;
  if constexpr (PE) {
    gbrk = fscal[b * 8 + 5];
    obrk = fscal[b * 8 + 6];
    if (iscal[b * 8 + 2] >= 0) jbrk = iscal[b * 8 + 2];
  }
  const int cornerd = L + R - 2;
  const int ctid = (L - 1) / ROWS, kc = (L - 1) - ctid * ROWS;
  const int i0 = tid * ROWS;
  // Lp is a whole number of warps: a thread's rows all exist or none
  const bool live = i0 < Lp;
  // the diagonals on which this warp has a cell to compute: row i has
  // one on d iff d - R <= i <= min(d, L)
  const int wlo = w * 32 * ROWS;
  const int dfirst = wlo;
  const int dlast =
      (wlo <= L && wlo < Lp) ? min(wlo + 32 * ROWS - 1, L) + R : -1;
  const size_t rowoff = (size_t)b * Lp + i0;
  const float* msp = ms + (size_t)b * D * Lp + i0;
  Code* cp = reinterpret_cast<Code*>(codes + (size_t)b * D * Lp + i0);

  // per-row inputs, once a launch; bounds on j shifted to bounds on jb
  float gx[ROWS], olp[ROWS];
  int lox[ROWS], loy[ROWS], hi[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = i0 + k;
    gx[k] = live ? gexti[rowoff + k] : 0.0f;
    olp[k] = live && i > 0 ? ol[rowoff + k - 1] : 0.0f;
    lox[k] = live ? add_sat(vlox[rowoff + k], k) : 0x7fffffff;
    loy[k] = live ? add_sat(vloy[rowoff + k], k) : 0x7fffffff;
    hi[k] = live ? add_sat(vhi[rowoff + k], k) : -1;
  }

  // diagonal 0: M(0, 0) = 0, all else -inf. M's maximum and code for
  // diagonal 1 come from diagonal -1 (all -inf): -inf and code 0. The
  // PE builds keep M's three candidates instead (mcn, mcx, mcy), to be
  // compared once the score is added.
  float Mr[ROWS], Xr[ROWS], Yr[ROWS], mcn[ROWS], mcx[ROWS], mcy[ROWS];
  uint32_t bmn = 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    Mr[k] = (i0 + k == 0) ? 0.0f : NEG;
    Xr[k] = Yr[k] = mcn[k] = mcx[k] = mcy[k] = NEG;
  }
  // the match scores of diagonals d+1 .. d+AHEAD during step d
  float msq[AHEAD][ROWS];
  auto fetch = [&](float (&v)[ROWS], int e) {
    if (live && e < D && e >= dfirst && e <= dlast)
      load_rows<ROWS>(v, msp + (size_t)e * Lp);
  };
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) msq[a][k] = 0.0f;
    fetch(msq[a], 1 + a);
  }
  if (live) cp[0] = (Code)(0x3F3F3F3Fu);
  if (tid == 0) {
    corner[b * 3 + 0] = NEG;
    corner[b * 3 + 1] = NEG;
    corner[b * 3 + 2] = NEG;
  }
  if (lane == 31)
    edge[0][w] = make_float4(Mr[ROWS - 1], Xr[ROWS - 1], Yr[ROWS - 1], 0.f);
  __syncthreads();

  auto step = [&](int d) {
    const bool active = d >= dfirst && d <= dlast;
    float msd[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      msd[k] = msq[0][k];
#pragma unroll
      for (int a = 0; a + 1 < AHEAD; ++a) msq[a][k] = msq[a + 1][k];
    }
    fetch(msq[AHEAD - 1], d + AHEAD);
    uint32_t code = 0;
    if (active) {
      // row i0 - 1 on diagonal d-1: the thread below, or the warp below
      float pm = __shfl_up_sync(FULL, Mr[ROWS - 1], 1);
      float px = __shfl_up_sync(FULL, Xr[ROWS - 1], 1);
      float py = __shfl_up_sync(FULL, Yr[ROWS - 1], 1);
      if (lane == 0) {
        const float4 e = w > 0 ? edge[(d - 1) & 1][w - 1]
                               : make_float4(NEG, NEG, NEG, 0.f);
        pm = e.x;
        px = e.y;
        py = e.z;
      }
      const int jb = d - i0;            // j of row i0 + k is jb - k
      const int jr = jb - (R - 1);      // == k where j == R - 1
      const int jk = jb - jbrk;         // == k where j == jbrk
      uint32_t bmnext = 0;
      float Mn[ROWS], Xn[ROWS], Yn[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        // row i's code byte is byte k of the thread's word; its bits
        // are built in place: bm 0-1, bx 2-3, by 4-5
        const int sh = 8 * k;
        // M, X, Y of diagonal d-1 at row i-1 and at row i
        const float m1p = k == 0 ? pm : Mr[k - 1];
        const float x1p = k == 0 ? px : Xr[k - 1];
        const float y1p = k == 0 ? py : Yr[k - 1];
        const float m1 = Mr[k], x1 = Xr[k], y1 = Yr[k];
        // X: gap consuming left site i (ext, double, open)
        float gj = (jb == k || jr == k) ? gend : gext;
        if (PE && jk == k) gj = gbrk;
        const float t1 = m1p + lng;
        const float cx0 = x1p + gj;
        const float cx1 = y1p + lgo;
        const float cx2 = t1 + olp[k];
        const float v01 = fmaxf(cx0, cx1);
        const float xc = fmaxf(v01, cx2);
        const uint32_t bx =
            (cx2 > v01) ? 8u << sh : ((cx1 > cx0) ? 4u << sh : 0u);
        // Y: gap consuming right site j (ext, double, open)
        float orp = (jb == k + 1) ? orp0 : lgo;
        if (PE && jk == k + 1) orp = obrk;
        const float cy0 = y1 + gx[k];
        const float cy1 = x1 + lgo;
        const float cy2 = (m1 + lng) + orp;
        const float w01 = fmaxf(cy0, cy1);
        const float yc = fmaxf(w01, cy2);
        const uint32_t by =
            (cy2 > w01) ? 32u << sh : ((cy1 > cy0) ? 16u << sh : 0u);
        // M of d from (mc, bm) taken at step d-1
        const bool okx = jb >= lox[k] && jb <= hi[k];
        const bool oky = jb >= loy[k] && jb <= hi[k];
        Xn[k] = okx ? xc : NEG;
        Yn[k] = oky ? yc : NEG;
        code += bx + by;
        if constexpr (PE) {
          // M's candidates with the score added, compared now
          const float a0 = mcn[k] + msd[k];
          const float a1 = mcx[k] + msd[k];
          const float a2 = mcy[k] + msd[k];
          const float z01 = fmaxf(a0, a1);
          Mn[k] = (okx && oky) ? fmaxf(z01, a2) : NEG;
          code += (a2 > z01) ? 2u << sh : ((a1 > a0) ? 1u << sh : 0u);
          // M's candidates at (i, j+1) on diagonal d+1
          mcn[k] = t1;
          mcx[k] = x1p;
          mcy[k] = y1p;
        } else {
          Mn[k] = (okx && oky) ? mcn[k] + msd[k] : NEG;
          // M's maximum and code at (i, j+1) on diagonal d+1: the
          // values of row i-1 on diagonal d-1 that X just read
          const float u01 = fmaxf(t1, x1p);
          mcn[k] = fmaxf(u01, y1p);
          bmnext += (y1p > u01) ? 2u << sh : ((x1p > t1) ? 1u << sh : 0u);
        }
      }
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        Mr[k] = Mn[k];
        Xr[k] = Xn[k];
        Yr[k] = Yn[k];
      }
      code += bmn;
      bmn = bmnext;
    } else {
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        Mr[k] = Xr[k] = Yr[k] = mcn[k] = mcx[k] = mcy[k] = NEG;
      bmn = 0;
    }
    if (live) cp[(size_t)d * (Lp / ROWS)] = (Code)code;
    if (lane == 31)
      edge[d & 1][w] = make_float4(Mr[ROWS - 1], Xr[ROWS - 1],
                                   Yr[ROWS - 1], 0.f);
    if (d == cornerd && tid == ctid) {
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (k == kc) {
          corner[b * 3 + 0] = Mr[k];
          corner[b * 3 + 1] = Xr[k];
          corner[b * 3 + 2] = Yr[k];
        }
    }
    __syncthreads();
  };
  if constexpr (AHEAD == 2) {
    // two steps a turn, so the two match-score buffers swap names, not
    // values
#pragma unroll 2
    for (int d = 1; d < D; ++d) step(d);
  } else {
    for (int d = 1; d < D; ++d) step(d);
  }
}

// The global build: threads stride over the rows; the three diagonals
// live in the global scratch gbuf (B, 9, Lp).
template <bool PE>
__global__ void viterbi_linear_global_kernel(
    const float* __restrict__ ms, const float* __restrict__ gexti,
    const float* __restrict__ ol, const int* __restrict__ vlox,
    const int* __restrict__ vloy, const int* __restrict__ vhi,
    const float* __restrict__ fscal, const int* __restrict__ iscal,
    uint8_t* __restrict__ codes, float* __restrict__ corner,
    float* __restrict__ gbuf, int D, int Lp) {
  const int b = blockIdx.x;
  // [gen 0..2][mat M,X,Y][Lp]
  float* sh = gbuf + (size_t)b * 9 * Lp;
  const int nt = blockDim.x;
  const float NEG = -CUDART_INF_F;
  const float gext = fscal[b * 8 + 0];
  const float gend = fscal[b * 8 + 1];
  const float lgo = fscal[b * 8 + 2];
  const float lng = fscal[b * 8 + 3];
  const float orp0 = fscal[b * 8 + 4];
  const int L = iscal[b * 8 + 0];
  const int R = iscal[b * 8 + 1];
  float gbrk = 0.0f, obrk = 0.0f;
  int jbrk = NO_BREAK;
  if constexpr (PE) {
    gbrk = fscal[b * 8 + 5];
    obrk = fscal[b * 8 + 6];
    if (iscal[b * 8 + 2] >= 0) jbrk = iscal[b * 8 + 2];
  }
  const int cornerd = L + R - 2;
  const size_t rowoff = (size_t)b * Lp;
  const float* msb = ms + (size_t)b * D * Lp;
  uint8_t* cb = codes + (size_t)b * D * Lp;

  // generation d = 0 in slot 0: M(0, 0) = 0, all else -inf; slots 1
  // and 2 (diagonals -2 and -1) all -inf
  for (int i = threadIdx.x; i < Lp; i += nt) {
    for (int q = 0; q < 9; ++q) sh[q * Lp + i] = NEG;
    if (i == 0) sh[0] = 0.0f;
    cb[i] = 0x3F;
  }
  if (threadIdx.x == 0) {
    corner[b * 3 + 0] = NEG;
    corner[b * 3 + 1] = NEG;
    corner[b * 3 + 2] = NEG;
  }
  __syncthreads();

  for (int d = 1; d < D; ++d) {
    const float* g1 = sh + ((d - 1) % 3) * 3 * Lp;   // diagonal d-1
    const float* g2 = sh + ((d + 1) % 3) * 3 * Lp;   // diagonal d-2
    float* g0 = sh + (d % 3) * 3 * Lp;               // diagonal d
    const float* msd = msb + (size_t)d * Lp;
    uint8_t* cd = cb + (size_t)d * Lp;
    for (int i = threadIdx.x; i < Lp; i += nt) {
      const int j = d - i;
      float m1p = NEG, x1p = NEG, y1p = NEG;
      float m2p = NEG, x2p = NEG, y2p = NEG;
      float olp = 0.0f;
      if (i > 0) {
        m1p = g1[i - 1];
        x1p = g1[Lp + i - 1];
        y1p = g1[2 * Lp + i - 1];
        m2p = g2[i - 1];
        x2p = g2[Lp + i - 1];
        y2p = g2[2 * Lp + i - 1];
        olp = ol[rowoff + i - 1];
      }
      // X: gap consuming left site i (ext, double, open)
      float gj = (j == 0 || j == R - 1) ? gend : gext;
      if (PE && j == jbrk) gj = gbrk;
      const float cx0 = x1p + gj;
      const float cx1 = y1p + lgo;
      const float cx2 = (m1p + lng) + olp;
      const float v01 = fmaxf(cx0, cx1);
      const float xc = fmaxf(v01, cx2);
      const int bx = (cx2 > v01) ? 2 : ((cx1 > cx0) ? 1 : 0);
      // Y: gap consuming right site j (ext, double, open)
      const float m1 = g1[i], x1 = g1[Lp + i], y1 = g1[2 * Lp + i];
      float orp = (j - 1 == 0) ? orp0 : lgo;
      if (PE && j - 1 == jbrk) orp = obrk;
      const float cy0 = y1 + gexti[rowoff + i];
      const float cy1 = x1 + lgo;
      const float cy2 = (m1 + lng) + orp;
      const float w01 = fmaxf(cy0, cy1);
      const float yc = fmaxf(w01, cy2);
      const int by = (cy2 > w01) ? 2 : ((cy1 > cy0) ? 1 : 0);
      // M: match consuming both (m, x, y); the PE build compares the
      // candidates with the score added
      const float t2 = m2p + lng;
      float mc;
      int bm;
      if constexpr (PE) {
        const float a0 = t2 + msd[i], a1 = x2p + msd[i], a2 = y2p + msd[i];
        const float z01 = fmaxf(a0, a1);
        mc = fmaxf(z01, a2);
        bm = (a2 > z01) ? 2 : ((a1 > a0) ? 1 : 0);
      } else {
        const float u01 = fmaxf(t2, x2p);
        mc = fmaxf(u01, y2p) + msd[i];
        bm = (y2p > u01) ? 2 : ((x2p > t2) ? 1 : 0);
      }

      const bool okx = (j >= vlox[rowoff + i]) && (j <= vhi[rowoff + i]);
      const bool oky = (j >= vloy[rowoff + i]) && (j <= vhi[rowoff + i]);
      const float X = okx ? xc : NEG;
      const float Y = oky ? yc : NEG;
      const float M = (okx && oky) ? mc : NEG;
      g0[i] = M;
      g0[Lp + i] = X;
      g0[2 * Lp + i] = Y;
      cd[i] = (uint8_t)(bm | (bx << 2) | (by << 4));
      if (d == cornerd && i == L - 1) {
        corner[b * 3 + 0] = M;
        corner[b * 3 + 1] = X;
        corner[b * 3 + 2] = Y;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// The plan, as viterbi_linear.py::linear_plan computes it: rows a thread
// (1, 2 or 4: Lp a whole number of warps, rows * threads >= Lp, at most
// 1024 threads; 0: the global build, gbuf (B, 9, Lp) required) and
// threads. Any other plan is refused with cudaErrorInvalidValue.
// pair_end: 1 takes the PE builds (a batch of pair-end jobs), 0 the
// ordinary builds.
extern "C" int viterbi_linear_launch(
    const void* ms, const void* gexti, const void* ol, const void* vlox,
    const void* vloy, const void* vhi, const void* fscal,
    const void* iscal, void* codes, void* corner, void* gbuf, int B,
    int D, int Lp, int rows, int threads, int pair_end, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (threads < 32 || threads > 1024 || threads % 32 || D < 2 || Lp < 1 ||
      (pair_end != 0 && pair_end != 1))
    return (int)cudaErrorInvalidValue;
  const float* m = (const float*)ms;
  const float* gx = (const float*)gexti;
  const float* o = (const float*)ol;
  const int* lx = (const int*)vlox;
  const int* ly = (const int*)vloy;
  const int* h = (const int*)vhi;
  const float* fs = (const float*)fscal;
  const int* is = (const int*)iscal;
  uint8_t* c = (uint8_t*)codes;
  float* k = (float*)corner;
  if (rows == 0) {
    if (gbuf == nullptr) return (int)cudaErrorInvalidValue;
    if (pair_end)
      viterbi_linear_global_kernel<true><<<B, threads, 0, st>>>(
          m, gx, o, lx, ly, h, fs, is, c, k, (float*)gbuf, D, Lp);
    else
      viterbi_linear_global_kernel<false><<<B, threads, 0, st>>>(
          m, gx, o, lx, ly, h, fs, is, c, k, (float*)gbuf, D, Lp);
    return (int)cudaGetLastError();
  }
  if (Lp % 32 || (long)rows * threads < Lp) return (int)cudaErrorInvalidValue;
  switch (rows) {
#define LIN_LANES(n)                                                       \
  case n:                                                                  \
    if (pair_end)                                                          \
      viterbi_linear_lanes_kernel<n, true><<<B, threads, 0, st>>>(         \
          m, gx, o, lx, ly, h, fs, is, c, k, D, Lp);                       \
    else                                                                   \
      viterbi_linear_lanes_kernel<n, false><<<B, threads, 0, st>>>(        \
          m, gx, o, lx, ly, h, fs, is, c, k, D, Lp);                       \
    return (int)cudaGetLastError();
    LIN_LANES(1)
    LIN_LANES(2)
    LIN_LANES(4)
#undef LIN_LANES
    default:
      return (int)cudaErrorInvalidValue;
  }
}
