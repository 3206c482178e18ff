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
// Layout: kernel A's lane builds (csrc/viterbi_linear.cu, points 1-6),
// so that the flag sets split kernel A's own step. ROWS = 1, 2 or 4
// consecutive rows a thread, up to 4096 rows in whole warps:
//  1. A thread's rows keep their M, X, Y of diagonal d-1 in registers.
//     Row s = i - 1 of its first row comes from the thread below by
//     __shfl_up_sync, across warps from a shared row of warp-edge values
//     taken in turn by the parity of d; so one __syncthreads a diagonal
//     (in every flag set, NOROLL too). The roll is circular: lane 0 of
//     warp 0 takes row Lp - 1 from slot 0 of the edge row, which the
//     thread owning that row writes each diagonal (warp w's edge is
//     slot w + 1, so every lane 0 reads slot w: one load, no select).
//     Under NOROLL a row reads its own registers only: no shuffle, no
//     edge row.
//  2. M reads only diagonal d-2 at row s, the values X read at step d-1:
//     so step d-1 takes M's maximum and its code bits for step d.
//  3. The per-row inputs (gexti[i], ol[s] with ol[Lp - 1] for row 0 under
//     the roll, the bounds shifted into bounds on jb = d - i0) are loaded
//     once a launch; the j-dependent selects compare jb with per-row
//     constants. The match score is the only load left on the step.
//  4. The match score of d+1 (and d+2 with one row a thread) is loaded
//     while step d runs, one 4, 8 or 16-byte load a thread; the codes of
//     a thread's rows are built in place in one word and leave in one
//     store (none under the probe's NOBP, a 0 word under the bisect's).
//  5. The corner capture is tested once a diagonal: at d == cornerd each
//     thread stores its rows' M, X and Y (set to NEG at the start).
//  6. Warp skip, with the masks on only: row r is valid on the diagonals
//     [r + vlo[r], r + vhi[r]] (row 0 also holds M(0, 0) = 0 on diagonal
//     0) and NEG in M, X and Y on every other. A warp's cells on d read
//     its own rows on d-1 and its source rows (its rows moved down one,
//     with row Lp - 1 for row 0 under the roll) on d-1 and d-2. With its
//     own rows' valid diagonals in [Ao, Bo] and its source rows' in
//     [As, Bs], a warp off [min(Ao, As + 1), max(Bo + 1, Bs + 2)] has
//     every cell masked and every source NEG: M, X, Y NEG and code 0 in
//     the plain version too, if NEG + x == NEG for every addend x
//     (the probe's -inf: x finite; the bisect's -1e30: |x| < 2^74, past
//     which the sum rounds off -1e30). The block tests that on fscal,
//     gexti and ol once a launch and computes every warp otherwise. Such
//     a warp stores code 0 and sets its rows to NEG without computing.
//     Under NOMASK values run on past every bound: no skip.
// The global build (ROWS 0, past 4096 rows or rows that are not whole
// warps): one block per job, threads strided over the rows, the three
// diagonals of M/X/Y in a global scratch (B, 9, Lp) resident in L2.
//
// The launch plan is viterbi_linear_probe.probe_plan: kernel A's lane
// plan up to 2048 rows, then four rows a thread up to 4096 and the
// global build past that (kernel A runs its tiled build past 2048 rows,
// which F does not have); the kernel takes only a plan it has a build
// for and refuses any other.
//
// What bounds it on an H100: the same serial chain of Dpk dependent
// diagonals as kernel A, each ending in a block barrier, B blocks on 132
// SMs; the bytes (up to 4 B read and 1 B written a cell) and operations
// are far below the card's rates. It exists to split that chain's step,
// not to be fast.
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

constexpr unsigned FULL = 0xffffffffu;
constexpr int INT_BIG = 0x7fffffff;

// a + b clamped to INT_MAX (b >= 0): a row's bound on j shifted into a
// bound on jb = j + k keeps its meaning for every jb a launch reaches
__device__ __forceinline__ int add_sat(int a, int b) {
  return a > INT_BIG - b ? INT_BIG : a + b;
}

// the valid diagonals [lo, hi] of row r (lo > hi: none), clamped to
// [-4, Dpk + 4] so that the warp's bounds below cannot overflow
__device__ __forceinline__ void row_span(const int* vlo, const int* vhi,
                                         size_t rowoff, int r, int Dpk,
                                         int& lo, int& hi) {
  const long long a = (long long)r + vlo[rowoff + r];
  const long long z = (long long)r + vhi[rowoff + r];
  lo = (int)min(max(a, -4LL), (long long)Dpk + 4);
  hi = (int)min(max(z, -4LL), (long long)Dpk + 4);
  if (a > z) {
    lo = Dpk + 8;
    hi = -8;
  }
  if (r == 0) {              // M(0, 0) = 0 on diagonal 0
    lo = min(lo, 0);
    hi = max(hi, 0);
  }
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

template <int ROWS>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[ROWS]) {
  typename Vec<ROWS>::F t;
  float* f = reinterpret_cast<float*>(&t);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) f[k] = v[k];
  *reinterpret_cast<typename Vec<ROWS>::F*>(p) = t;
}

template <int FLAGS, int ROWS>
__global__ void __launch_bounds__(1024) viterbi_probe_lanes_kernel(
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
    float NEG, int B, int Dpk, int Lp) {
  constexpr bool bisect = (FLAGS & BISECT) != 0;
  constexpr bool codes = (FLAGS & NOBP) == 0;
  constexpr bool store = codes || bisect;
  constexpr bool readms = (FLAGS & NOMS) == 0;
  constexpr bool masks = (FLAGS & NOMASK) == 0;
  constexpr bool selects = masks || !bisect;
  constexpr bool corner = (FLAGS & NOCORNER) == 0;
  constexpr bool roll = (FLAGS & NOROLL) == 0;
  typedef typename Vec<ROWS>::C Code;
  // diagonals of match scores loaded ahead: two for one row a thread
  // (whose short step does not hide one load), one for two and four
  constexpr int AHEAD = ROWS == 1 ? 2 : 1;
  // by the parity of their diagonal: row Lp - 1's M, X, Y in slot 0 (the
  // roll's wrap), the last row's of warp w in slot w + 1; lane 0 of warp
  // w reads slot w
  __shared__ float4 edge[2][33];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const float gext = fscal[b * 8 + 0];
  const float gend = fscal[b * 8 + 1];
  const float lgo = fscal[b * 8 + 2];
  const float lng = fscal[b * 8 + 3];
  const float orp0 = fscal[b * 8 + 4];
  const int Rdp = iscal[b * 8 + 0];
  const int cornerd = iscal[b * 8 + 1];
  const int i0 = tid * ROWS;
  // Lp is a whole number of warps: a thread's rows all exist or none
  const bool live = i0 < Lp;
  // the thread that owns row Lp - 1 (its last row)
  const int tlast = Lp / ROWS - 1;
  const size_t rowb = (size_t)b * Lp;
  const size_t rowoff = rowb + i0;
  const size_t dstride = (size_t)B * Lp;     // one diagonal of ms and bp
  // the thread's rows on the next match-score diagonal to load and on
  // the diagonal whose codes step d stores, moved on by one diagonal a
  // step
  const float* msp = ms + rowoff + (size_t)AHEAD * dstride;
  Code* cp = reinterpret_cast<Code*>(bp + rowoff);

  // per-row inputs, once a launch; bounds on j shifted to bounds on jb
  // = d - i0. Row i0 + k's X source row s has js = (d-1) - s = jb - g[k]:
  // g[k] = k with the roll (row 0: Lp, its source row Lp - 1), k + 1
  // without.
  const int g0 = roll ? (i0 == 0 ? Lp : 0) : 1;
  float gx[ROWS], olp[ROWS];
  int lox[ROWS], loy[ROWS], hi[ROWS];
  // NEG + x == NEG for every addend x (point 6): finite for the probe's
  // -inf, |x| < 2^74 for the bisect's -1e30
  const float lim = bisect ? 1.8889466e22f : CUDART_INF_F;
  bool exact = fabsf(gext) < lim && fabsf(gend) < lim && fabsf(lgo) < lim &&
               fabsf(lng) < lim && fabsf(orp0) < lim;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = i0 + k;
    const int s = roll ? (i > 0 ? i - 1 : Lp - 1) : i;
    gx[k] = live ? gexti[rowb + i] : 0.0f;
    olp[k] = live ? ol[rowb + s] : 0.0f;
    exact = exact && fabsf(gx[k]) < lim && fabsf(olp[k]) < lim;
    if (masks) {
      const int vl = live ? vlo[rowb + i] : INT_BIG;
      lox[k] = live && i > 0 ? add_sat(vl, k) : INT_BIG;
      loy[k] = live ? add_sat(max(vl, 1), k) : INT_BIG;
      hi[k] = live ? add_sat(vhi[rowb + i], k) : -1;
    }
  }

  // the diagonals on which this warp computes (point 6)
  int dfirst = 1, dlast = INT_BIG;
  if (masks) {
    int ao = Dpk + 8, bo = -8, as = Dpk + 8, bs = -8;
    if (live) {
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        int lo, h;
        row_span(vlo, vhi, rowb, i0 + k, Dpk, lo, h);
        ao = min(ao, lo);
        bo = max(bo, h);
        if (k + 1 < ROWS) {       // row i0 + k is row i0 + k + 1's source
          as = min(as, lo);
          bs = max(bs, h);
        }
      }
      const int s0 = roll ? (i0 > 0 ? i0 - 1 : Lp - 1) : i0 + ROWS - 1;
      int lo, h;
      row_span(vlo, vhi, rowb, s0, Dpk, lo, h);
      as = min(as, lo);
      bs = max(bs, h);
    }
    int first = min(ao, as + 1), last = max(bo + 1, bs + 2);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      first = min(first, __shfl_xor_sync(FULL, first, o));
      last = max(last, __shfl_xor_sync(FULL, last, o));
    }
    if (__syncthreads_and(exact)) {
      dfirst = first;
      dlast = last;
    }
  }

  // diagonal 0: M(0, 0) = 0, all else NEG. M's maximum and code for
  // diagonal 1 come from diagonal -1 (all NEG): NEG and code 0.
  float Mr[ROWS], Xr[ROWS], Yr[ROWS], mcn[ROWS];
  uint32_t bmn = 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    Mr[k] = (i0 + k == 0) ? 0.0f : NEG;
    Xr[k] = Yr[k] = mcn[k] = NEG;
  }
  if (live) {            // the corner rows NEG (Xr: no M(0, 0) there)
    store_rows<ROWS>(fM + rowoff, Xr);
    store_rows<ROWS>(fX + rowoff, Xr);
    store_rows<ROWS>(fY + rowoff, Xr);
  }
  // the match scores of diagonals d+1 .. d+AHEAD during step d
  float msq[AHEAD][ROWS];
  auto fetch = [&](float (&v)[ROWS], int e, const float* p) {
    if (readms && live && e <= Dpk && e >= dfirst && e <= dlast)
      load_rows<ROWS>(v, p);
  };
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) msq[a][k] = 0.0f;
    fetch(msq[a], 1 + a, ms + rowoff + (size_t)a * dstride);
  }
  if (roll) {
    if (lane == 31)
      edge[0][w + 1] =
          make_float4(Mr[ROWS - 1], Xr[ROWS - 1], Yr[ROWS - 1], 0.f);
    if (tid == tlast)
      edge[0][0] = make_float4(Mr[ROWS - 1], Xr[ROWS - 1], Yr[ROWS - 1], 0.f);
  }
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
    fetch(msq[AHEAD - 1], d + AHEAD, msp);
    msp += dstride;
    uint32_t code = 0;
    if (active) {
      // row s of the thread's first row on diagonal d-1: the thread
      // below, the warp below, or (warp 0) row Lp - 1
      float pm = NEG, px = NEG, py = NEG;
      if (roll) {
        pm = __shfl_up_sync(FULL, Mr[ROWS - 1], 1);
        px = __shfl_up_sync(FULL, Xr[ROWS - 1], 1);
        py = __shfl_up_sync(FULL, Yr[ROWS - 1], 1);
        if (lane == 0) {
          const float4 e = edge[(d - 1) & 1][w];
          pm = e.x;
          px = e.y;
          py = e.z;
        }
      }
      const int jb = d - i0;            // j of row i0 + k is jb - k
      const int jr = jb - (Rdp - 1);
      uint32_t bmnext = 0;
      float Mn[ROWS], Xn[ROWS], Yn[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        // row i's code byte is byte k of the thread's word; its bits
        // are built in place: bm 0-1, bx 2-3, by 4-5
        const int sh = 8 * k;
        // M, X, Y of diagonal d-1 at the source row s and at row i
        const float m1 = Mr[k], x1 = Xr[k], y1 = Yr[k];
        const float m1p = !roll ? m1 : (k == 0 ? pm : Mr[k - 1]);
        const float x1p = !roll ? x1 : (k == 0 ? px : Xr[k - 1]);
        const float y1p = !roll ? y1 : (k == 0 ? py : Yr[k - 1]);
        // X: ext, double, open, formed at row s
        const int gk = k == 0 ? g0 : (roll ? k : k + 1);
        const float gj =
            selects ? ((jb == gk || jr == gk) ? gend : gext) : gext;
        const float t1 = m1p + lng;
        const float cx0 = x1p + gj;
        const float cx1 = y1p + lgo;
        const float cx2 = t1 + olp[k];
        const float v01 = fmaxf(cx0, cx1);
        const float xc = fmaxf(v01, cx2);
        // Y: ext, double, open, at row i
        const float orp = selects ? ((jb == k + 1) ? orp0 : lgo) : lgo;
        const float cy0 = y1 + gx[k];
        const float cy1 = x1 + lgo;
        const float cy2 = (m1 + lng) + orp;
        const float w01 = fmaxf(cy0, cy1);
        const float yc = fmaxf(w01, cy2);
        const float msv = readms ? msd[k] : 0.0f;
        if (masks) {
          const bool okx = jb >= lox[k] && jb <= hi[k];
          const bool oky = jb >= loy[k] && jb <= hi[k];
          Xn[k] = okx ? xc : NEG;
          Yn[k] = oky ? yc : NEG;
          Mn[k] = (okx && oky) ? mcn[k] + msv : NEG;
        } else {
          Xn[k] = xc;
          Yn[k] = yc;
          Mn[k] = mcn[k] + msv;
        }
        if (codes) {
          code += (cx2 > v01) ? 8u << sh : ((cx1 > cx0) ? 4u << sh : 0u);
          code += (cy2 > w01) ? 32u << sh : ((cy1 > cy0) ? 16u << sh : 0u);
        }
        // M's maximum and code at row i on diagonal d+1: the values of
        // row s on diagonal d-1 that X just read
        const float u01 = fmaxf(t1, x1p);
        mcn[k] = fmaxf(u01, y1p);
        if (codes)
          bmnext += (y1p > u01) ? 2u << sh : ((x1p > t1) ? 1u << sh : 0u);
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
      for (int k = 0; k < ROWS; ++k) Mr[k] = Xr[k] = Yr[k] = mcn[k] = NEG;
      bmn = 0;
    }
    if (store && live) *cp = codes ? (Code)code : (Code)0;
    cp += dstride / ROWS;
    if (roll) {
      if (lane == 31)
        edge[d & 1][w + 1] = make_float4(Mr[ROWS - 1], Xr[ROWS - 1],
                                         Yr[ROWS - 1], 0.f);
      if (tid == tlast)
        edge[d & 1][0] = make_float4(Mr[ROWS - 1], Xr[ROWS - 1],
                                     Yr[ROWS - 1], 0.f);
    }
    if (corner && d == cornerd && live) {
      store_rows<ROWS>(fM + rowoff, Mr);
      store_rows<ROWS>(fX + rowoff, Xr);
      store_rows<ROWS>(fY + rowoff, Yr);
    }
    __syncthreads();
  };
  if constexpr (AHEAD == 2) {
    // two steps a turn, so the two match-score buffers swap names, not
    // values
#pragma unroll 2
    for (int d = 1; d <= Dpk; ++d) step(d);
  } else {
    for (int d = 1; d <= Dpk; ++d) step(d);
  }
}

// The global build: threads stride over the rows; the three diagonals
// live in the global scratch gbuf (B, 9, Lp). 1024 threads a block: the
// bound keeps every flag set at 64 registers or fewer (nocorner needed
// 66 without it and could not launch).
template <int FLAGS>
__global__ void __launch_bounds__(1024) viterbi_probe_global_kernel(
    const float* __restrict__ fscal, const int* __restrict__ iscal,
    const float* __restrict__ gexti, const float* __restrict__ ol,
    const int* __restrict__ vlo, const int* __restrict__ vhi,
    const float* __restrict__ ms, int8_t* __restrict__ bp,
    float* __restrict__ fM, float* __restrict__ fX, float* __restrict__ fY,
    float* __restrict__ gbuf, float NEG, int B, int Dpk, int Lp) {
  constexpr bool bisect = (FLAGS & BISECT) != 0;
  constexpr bool codes = (FLAGS & NOBP) == 0;
  constexpr bool store = codes || bisect;
  constexpr bool readms = (FLAGS & NOMS) == 0;
  constexpr bool masks = (FLAGS & NOMASK) == 0;
  constexpr bool selects = masks || !bisect;
  constexpr bool corner = (FLAGS & NOCORNER) == 0;
  constexpr bool roll = (FLAGS & NOROLL) == 0;
  const int b = blockIdx.x;
  // [gen 0..2][mat M,X,Y][Lp]
  float* sh = gbuf + (size_t)b * 9 * Lp;
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
           int B, int Dpk, int Lp, int rows, int threads, cudaStream_t st) {
  const float* fs = (const float*)fscal;
  const int* is = (const int*)iscal;
  const float* gx = (const float*)gexti;
  const float* o = (const float*)ol;
  const int* lo = (const int*)vlo;
  const int* h = (const int*)vhi;
  const float* m = (const float*)ms;
  int8_t* c = (int8_t*)bp;
  float* a = (float*)fM;
  float* x = (float*)fX;
  float* y = (float*)fY;
  switch (rows) {
    case 0:
      viterbi_probe_global_kernel<FLAGS><<<B, threads, 0, st>>>(
          fs, is, gx, o, lo, h, m, c, a, x, y, (float*)gbuf, neg, B, Dpk,
          Lp);
      break;
#define PROBE_LANES(n)                                                     \
  case n:                                                                  \
    viterbi_probe_lanes_kernel<FLAGS, n><<<B, threads, 0, st>>>(           \
        fs, is, gx, o, lo, h, m, c, a, x, y, neg, B, Dpk, Lp);             \
    break;
    PROBE_LANES(1)
    PROBE_LANES(2)
    PROBE_LANES(4)
#undef PROBE_LANES
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// A plan has a build: rows a thread 1, 2 or 4 (Lp a whole number of
// warps, rows * threads >= Lp) or 0 (the global build, gbuf (B, 9, Lp)
// given), in a block of whole warps up to 1024 threads.
bool plan_ok(void* gbuf, int Dpk, int Lp, int rows, int threads) {
  if (threads < 32 || threads > 1024 || threads % 32 || Dpk < 1 || Lp < 1)
    return false;
  if (rows == 0) return gbuf != nullptr;
  return (rows == 1 || rows == 2 || rows == 4) && Lp % 32 == 0 &&
         (long)rows * threads >= Lp;
}

// returned for a flag set that has no instantiation
constexpr int UNKNOWN_FLAGS = -1;

}  // namespace

#define PROBE_ARGS                                                        \
  fscal, iscal, gexti, ol, vlo, vhi, ms, bp, fM, fX, fY, gbuf, neg, B,    \
      Dpk, Lp, rows, threads, (cudaStream_t)stream

// The probe's flag sets (tools/_probe_pallas.py's cases): base, nobp,
// noms, nomask, nocorner, nobp+noms, all-off. `rows` and `threads` are
// the plan (viterbi_linear_probe.probe_plan); any other plan is refused
// with cudaErrorInvalidValue, any other flag set with UNKNOWN_FLAGS.
extern "C" int viterbi_probe_launch(
    const void* fscal, const void* iscal, const void* gexti, const void* ol,
    const void* vlo, const void* vhi, const void* ms, void* bp, void* fM,
    void* fX, void* fY, void* gbuf, float neg, int B, int Dpk, int Lp,
    int rows, int threads, int flags, void* stream) {
  switch (flags) {
    case 0: case NOBP: case NOMS: case NOMASK: case NOCORNER:
    case NOBP | NOMS: case NOBP | NOMS | NOMASK | NOCORNER:
      break;
    default: return UNKNOWN_FLAGS;
  }
  if (!plan_ok(gbuf, Dpk, Lp, rows, threads))
    return (int)cudaErrorInvalidValue;
  switch (flags) {
    case 0: return launch<0>(PROBE_ARGS);
    case NOBP: return launch<NOBP>(PROBE_ARGS);
    case NOMS: return launch<NOMS>(PROBE_ARGS);
    case NOMASK: return launch<NOMASK>(PROBE_ARGS);
    case NOCORNER: return launch<NOCORNER>(PROBE_ARGS);
    case NOBP | NOMS: return launch<NOBP | NOMS>(PROBE_ARGS);
    default:
      return launch<NOBP | NOMS | NOMASK | NOCORNER>(PROBE_ARGS);
  }
}

// The bisect's variants (tools/_bisect_pallas.py's runs): full, nobp,
// noroll, nomask, nobp+noroll, nobp+noroll+nomask. `flags` holds the
// NOBP / NOMASK / NOROLL bits; BISECT is added here. The plan as for
// viterbi_probe_launch.
extern "C" int viterbi_bisect_launch(
    const void* fscal, const void* iscal, const void* gexti, const void* ol,
    const void* vlo, const void* vhi, const void* ms, void* bp, void* fM,
    void* fX, void* fY, void* gbuf, float neg, int B, int Dpk, int Lp,
    int rows, int threads, int flags, void* stream) {
  switch (flags) {
    case 0: case NOBP: case NOROLL: case NOMASK: case NOBP | NOROLL:
    case NOBP | NOROLL | NOMASK:
      break;
    default: return UNKNOWN_FLAGS;
  }
  if (!plan_ok(gbuf, Dpk, Lp, rows, threads))
    return (int)cudaErrorInvalidValue;
  switch (flags) {
    case 0: return launch<BISECT>(PROBE_ARGS);
    case NOBP: return launch<BISECT | NOBP>(PROBE_ARGS);
    case NOROLL: return launch<BISECT | NOROLL>(PROBE_ARGS);
    case NOMASK: return launch<BISECT | NOMASK>(PROBE_ARGS);
    case NOBP | NOROLL: return launch<BISECT | NOBP | NOROLL>(PROBE_ARGS);
    default:
      return launch<BISECT | NOBP | NOROLL | NOMASK>(PROBE_ARGS);
  }
}
