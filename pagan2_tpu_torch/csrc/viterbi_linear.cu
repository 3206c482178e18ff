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
// on 132 SMs in the lane builds, and a few tiles of a job in flight at
// a time in the tiled build (a tile trails the one below it by its 2T
// rows of diagonals). So a step costs its barrier, the latency of its chain and
// the cycles its instructions take to dispatch, and the design cuts all
// three.
//
// The lane builds (ROWS = 1 or 2 rows a thread, up to 2048 rows):
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
//     4 or 8-byte load a thread and diagonal) while step d runs. The
//     codes of a thread's rows are built in place in one word from
//     pre-shifted constants and leave in one 1 or 2-byte store,
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
// The tiled build (past 2048 rows, or a row count that is not a whole
// number of warps): the lane build's step on tiles of T threads x 2
// consecutive rows, many tiles of a job on many SMs in one launch. (It
// replaced a build of four rows a thread from 2049 to 4096 rows, which
// it beat by 12-37% a launch on 8-pair batches there, and the global
// build past that.)
//  7. Tile k of a job holds rows [i0, i1] (i0 = k * 2T) and runs only
//     its live diagonals d in [i0, min(i1, L) + R]: item 5's rule at
//     the tile's edges, so every code outside them is 0. The launcher
//     sets the codes to 0 once (cudaMemsetAsync) and a tile writes its
//     live diagonals and its rows of diagonal 0 (0x3F); a tile past a
//     job's L writes only those. The band never shortens a tile's
//     range: a banded-out cell inside the matrix keeps its code.
//  8. Tile k's first row reads row i0 - 1 of diagonal d-1, the last row
//     of tile k-1. The thread owning that row in tile k-1 writes its
//     M, X, Y of each diagonal to an edge array of its own in device
//     memory, one float4 a column j of that row, each written once (no
//     ring, no back-pressure), and after every C = CHUNK columns stores
//     the count written with release semantics (st.release.gpu). Warp 0
//     of tile k, at the start of each C diagonals, waits for that count
//     with acquire semantics, loads the C entries one a lane (L2, not
//     L1) and hands lane 0 one a step by __shfl_sync: a wait a chunk,
//     none in the step. Columns past R are -inf and not read.
//  9. Blocks claim (job, tile) tickets in increasing order from a
//     device counter, so a tile's predecessor was claimed earlier by a
//     block that is running it: no wait can deadlock, whatever order the
//     hardware starts blocks in. The grid is persistent (at most the
//     SMs times the blocks that fit on one); a block claims again when
//     its tile is done.
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
// The launch plan (rows a thread, threads, lane or tiled build) is
// align/viterbi_linear.py::linear_plan; the kernel
// only takes a plan it has a build for and refuses any other.
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

// a thread's ROWS match scores: one vector load, or (vec false: rows
// not aligned to it) one load a row of the first n
template <int ROWS>
__device__ __forceinline__ void load_rows(float (&v)[ROWS], const float* p,
                                          bool vec, int n) {
  if (vec) {
    const typename Vec<ROWS>::F t =
        __ldg(reinterpret_cast<const typename Vec<ROWS>::F*>(p));
    const float* f = reinterpret_cast<const float*>(&t);
#pragma unroll
    for (int k = 0; k < ROWS; ++k) v[k] = f[k];
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) v[k] = k < n ? __ldg(p + k) : 0.0f;
  }
}

// a thread's ROWS codes, byte k of `code` for row k: one store, or one a
// row of the first n
template <int ROWS>
__device__ __forceinline__ void store_rows(uint8_t* p, uint32_t code,
                                           bool vec, int n) {
  if (vec) {
    *reinterpret_cast<typename Vec<ROWS>::C*>(p) =
        (typename Vec<ROWS>::C)code;
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      if (k < n) p[k] = (uint8_t)(code >> (8 * k));
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// jbrk of a job with no break column: j - jbrk and j - 1 - jbrk never
// reach 0 for a j a launch meets
constexpr int NO_BREAK = -0x40000000;
// the count a tile publishes once its last diagonal is done
constexpr int ALL_DONE = 0x7fffffff;
// the tiled build's hand-off: columns of a tile's last row between two
// releases, and entries warp 0 of its successor loads at once (one a
// lane; tools/bench_linear_calls.py swept 1-32 on the H100: 8, 16 and 32
// within 3%, 1 slower by 17-28%)
constexpr int CHUNK = 32;
static_assert(CHUNK >= 1 && CHUNK <= 32, "a hand-off chunk is a warp's");

// A launch's tensors.
struct Batch {
  const float* ms;      // (B, D, Lp) folded, row d = diag d
  const float* gexti;   // (B, Lp)
  const float* ol;      // (B, Lp)
  const int* vlox;      // (B, Lp)
  const int* vloy;      // (B, Lp)
  const int* vhi;       // (B, Lp)
  const float* fscal;   // (B, 8): gext gend lgo lng orp0 gbrk obrk
  const int* iscal;     // (B, 8): L R jbrk pair-end
  uint8_t* codes;       // (B, D, Lp)
  float* corner;        // (B, 3)
  int D, Lp;
};

// The tiled build's hand-off (item 8): the predecessor's last row, one
// entry a column j, and the count of entries it has published; this
// tile's own, for its successor. Null pointers: no predecessor, or no
// live successor.
struct Handoff {
  const float4* pedge;
  const int* pprog;
  float4* oedge;
  int* oprog;
};

// Rows [r0, r0 + nrows) of job b on diagonals dbeg .. dend, ROWS
// consecutive rows a thread (items 1-6): every row of the job on every
// diagonal in a lane build, one tile's rows on its live diagonals in the
// tiled build (items 7-8). M, X, Y of diagonal dbeg - 1 start as the
// plain version's: 0 at (0, 0), -inf elsewhere.
template <int ROWS, bool PE, bool TILED>
__device__ __forceinline__ void fill_rows(const Batch& a, int b, int r0,
                                          int nrows, int dbeg, int dend,
                                          const Handoff& h,
                                          float4 (&edge)[2][32]) {
  // diagonals of match scores loaded ahead: two for one row a thread
  // (whose short step does not hide one load), one for two
  constexpr int AHEAD = ROWS == 1 ? 2 : 1;
  const int D = a.D, Lp = a.Lp;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const float NEG = -CUDART_INF_F;
  const float4 NEG4 = make_float4(NEG, NEG, NEG, 0.f);
  const float gext = a.fscal[b * 8 + 0];
  const float gend = a.fscal[b * 8 + 1];
  const float lgo = a.fscal[b * 8 + 2];
  const float lng = a.fscal[b * 8 + 3];
  const float orp0 = a.fscal[b * 8 + 4];
  const int L = a.iscal[b * 8 + 0];
  const int R = a.iscal[b * 8 + 1];
  float gbrk = 0.0f, obrk = 0.0f;
  int jbrk = NO_BREAK;
  if constexpr (PE) {
    gbrk = a.fscal[b * 8 + 5];
    obrk = a.fscal[b * 8 + 6];
    if (a.iscal[b * 8 + 2] >= 0) jbrk = a.iscal[b * 8 + 2];
  }
  const int cornerd = L + R - 2;
  // the thread that owns row L-1 and that row's place in its word
  const int ctid = L - 1 >= r0 ? (L - 1 - r0) / ROWS : -1;
  const int kc = (L - 1 - r0) - ctid * ROWS;
  const int i0 = r0 + tid * ROWS;
  // rows of this thread that exist: all or none in a lane build (Lp a
  // whole number of warps); the last tile may end inside a thread's rows
  const int nown = Lp - i0;
  const bool live = i0 < Lp;
  // one load and one store a diagonal where the rows stay aligned to
  // them: always in a lane build, in the tiled build when Lp is even
  const bool vec = !TILED || Lp % ROWS == 0;
  // the diagonals on which this warp has a cell to compute: row i has
  // one on d iff d - R <= i <= min(d, L)
  const int wlo = r0 + w * 32 * ROWS;
  const int dfirst = wlo;
  const int dlast =
      (wlo <= L && wlo < Lp) ? min(wlo + 32 * ROWS - 1, L) + R : -1;
  const size_t rowoff = (size_t)b * Lp + i0;
  const float* msp = a.ms + (size_t)b * D * Lp + i0;
  uint8_t* cp = a.codes + (size_t)b * D * Lp + i0;

  // per-row inputs, once a launch; bounds on j shifted to bounds on jb
  float gx[ROWS], olp[ROWS];
  int lox[ROWS], loy[ROWS], hi[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = i0 + k;
    const bool ok = i < Lp;
    gx[k] = ok ? a.gexti[rowoff + k] : 0.0f;
    olp[k] = ok && i > 0 ? a.ol[rowoff + k - 1] : 0.0f;
    lox[k] = ok ? add_sat(a.vlox[rowoff + k], k) : 0x7fffffff;
    loy[k] = ok ? add_sat(a.vloy[rowoff + k], k) : 0x7fffffff;
    hi[k] = ok ? add_sat(a.vhi[rowoff + k], k) : -1;
  }

  // diagonal dbeg - 1: M(0, 0) = 0, all else -inf. M's maximum and code
  // for diagonal dbeg come from diagonal dbeg - 2 (all -inf): -inf and
  // code 0. The PE builds keep M's three candidates instead (mcn, mcx,
  // mcy), to be compared once the score is added.
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
      load_rows<ROWS>(v, msp + (size_t)e * Lp, vec, nown);
  };
#pragma unroll
  for (int q = 0; q < AHEAD; ++q) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) msq[q][k] = 0.0f;
    fetch(msq[q], dbeg + q);
  }
  if (live) store_rows<ROWS>(cp, 0x3F3F3F3Fu, vec, nown);
  if (tid == 0 && (!TILED || (ctid >= 0 && L - 1 < r0 + nrows))) {
    a.corner[b * 3 + 0] = NEG;
    a.corner[b * 3 + 1] = NEG;
    a.corner[b * 3 + 2] = NEG;
  }
  if (lane == 31)
    edge[(dbeg - 1) & 1][w] =
        make_float4(Mr[ROWS - 1], Xr[ROWS - 1], Yr[ROWS - 1], 0.f);
  __syncthreads();

  // tiled build: warp 0's entries of the predecessor's last row, lane l
  // holding the one for diagonal dchunk + l; diagonals left in the
  // chunk; entries this tile writes before its next release
  float4 pev = NEG4;
  int dchunk = dbeg, pleft = 0, oleft = CHUNK;
  const int ilast = r0 + nrows - 1;

  auto step = [&](int d) {
    const bool active = d >= dfirst && d <= dlast;
    float msd[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      msd[k] = msq[0][k];
#pragma unroll
      for (int q = 0; q + 1 < AHEAD; ++q) msq[q][k] = msq[q + 1][k];
    }
    fetch(msq[AHEAD - 1], d + AHEAD);
    // row i0 - 1 on diagonal d-1 for the block's first row: -inf in a
    // lane build and in a job's first tile, else the predecessor's entry
    // j = d - r0 (row r0 - 1 is in the matrix up to column R - 1, so
    // entries past R are -inf and not read)
    float4 pe = NEG4;
    if constexpr (TILED) {
      if (w == 0 && h.pedge != nullptr) {
        if (pleft == 0) {
          const int j0 = d - r0;
          dchunk = d;
          pleft = CHUNK;
          pev = NEG4;
          if (j0 <= R) {
            const int need = min(j0 + CHUNK, R + 1);
            while (ld_acquire(h.pprog) < need) __nanosleep(32);
            if (lane < CHUNK && j0 + lane <= R && d + lane <= dend)
              pev = __ldcg(h.pedge + j0 + lane);
          }
        }
        --pleft;
        const int s = d - dchunk;
        pe.x = __shfl_sync(FULL, pev.x, s);
        pe.y = __shfl_sync(FULL, pev.y, s);
        pe.z = __shfl_sync(FULL, pev.z, s);
      }
    }
    uint32_t code = 0;
    if (active) {
      // row i0 - 1 on diagonal d-1: the thread below, or the warp below
      float pm = __shfl_up_sync(FULL, Mr[ROWS - 1], 1);
      float px = __shfl_up_sync(FULL, Xr[ROWS - 1], 1);
      float py = __shfl_up_sync(FULL, Yr[ROWS - 1], 1);
      if (lane == 0) {
        const float4 e = w > 0 ? edge[(d - 1) & 1][w - 1] : pe;
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
    // the tiled build leaves a skipped warp's codes at the launcher's 0
    if (live && (!TILED || active))
      store_rows<ROWS>(cp + (size_t)d * Lp, code, vec, nown);
    if (lane == 31)
      edge[d & 1][w] = make_float4(Mr[ROWS - 1], Xr[ROWS - 1],
                                   Yr[ROWS - 1], 0.f);
    if (d == cornerd && tid == ctid) {
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (k == kc) {
          a.corner[b * 3 + 0] = Mr[k];
          a.corner[b * 3 + 1] = Xr[k];
          a.corner[b * 3 + 2] = Yr[k];
        }
    }
    if constexpr (TILED) {
      // the last row's entry j = d - ilast for the successor, published
      // every chunk columns
      if (h.oedge != nullptr && tid == blockDim.x - 1 && d >= ilast) {
        __stcg(h.oedge + (d - ilast), make_float4(Mr[ROWS - 1], Xr[ROWS - 1],
                                                  Yr[ROWS - 1], 0.f));
        if (--oleft == 0) {
          oleft = CHUNK;
          st_release(h.oprog, d - ilast + 1);
        }
      }
    }
    __syncthreads();
  };
  if constexpr (AHEAD == 2) {
    // two steps a turn, so the two match-score buffers swap names, not
    // values
#pragma unroll 2
    for (int d = dbeg; d <= dend; ++d) step(d);
  } else {
    for (int d = dbeg; d <= dend; ++d) step(d);
  }
  if constexpr (TILED) {
    if (h.oedge != nullptr && tid == blockDim.x - 1)
      st_release(h.oprog, ALL_DONE);
  }
}

// The lane builds: one block a job, every row in registers.
template <int ROWS, bool PE>
__global__ void __launch_bounds__(1024)
    viterbi_linear_lanes_kernel(Batch a) {
  // last row's M, X, Y of each warp, by the parity of its diagonal
  __shared__ float4 edge[2][32];
  fill_rows<ROWS, PE, false>(a, blockIdx.x, 0, a.Lp, 1, a.D - 1,
                             Handoff{}, edge);
}

// The tiled build: blocks claim (job, tile) tickets in order; flags[0]
// is the claim counter, flags[1 + t] ticket t's published count, and
// edges + t * D its last row's entries (items 7-9).
template <bool PE>
__global__ void __launch_bounds__(1024) viterbi_linear_tiles_kernel(
    Batch a, float4* __restrict__ edges, int* __restrict__ flags, int B,
    int ntiles) {
  __shared__ float4 edge[2][32];
  __shared__ int ticket;
  const int rows = 2 * blockDim.x;
  for (;;) {
    // the last tile's reads of `ticket` and `edge` are done
    __syncthreads();
    if (threadIdx.x == 0) ticket = atomicAdd(flags, 1);
    __syncthreads();
    const int t = ticket;
    if (t >= B * ntiles) return;
    const int b = t / ntiles, k = t - b * ntiles;
    const int r0 = k * rows, nrows = min(rows, a.Lp - r0);
    const int L = a.iscal[b * 8 + 0], R = a.iscal[b * 8 + 1];
    if (r0 > L) {
      // no cell of the tile has a source in the matrix: its codes stay
      // 0 but diagonal 0's
      uint8_t* c0 = a.codes + (size_t)b * a.D * a.Lp + r0;
      for (int i = threadIdx.x; i < nrows; i += blockDim.x) c0[i] = 0x3F;
      continue;
    }
    Handoff h;
    h.pedge = k > 0 ? edges + (size_t)(t - 1) * a.D : nullptr;
    h.pprog = k > 0 ? flags + t : nullptr;
    // a successor is live iff its first row r0 + rows is at most L
    const bool feeds = k + 1 < ntiles && r0 + rows <= L;
    h.oedge = feeds ? edges + (size_t)t * a.D : nullptr;
    h.oprog = flags + 1 + t;
    fill_rows<2, PE, true>(a, b, r0, nrows, max(r0, 1),
                           min(a.D - 1, min(r0 + nrows - 1, L) + R), h,
                           edge);
  }
}

}  // namespace

// The plan, as viterbi_linear.py::linear_plan computes it: a lane build
// (tiled 0; rows a thread 1 or 2: Lp a whole number of warps,
// rows * threads >= Lp, at most 1024 threads) or the tiled build
// (tiled 1; rows 2, threads a tile of whole warps up to 1024; edges: a
// float4 (B * ntiles, D) buffer and flags an int (1 + B * ntiles) one,
// ntiles = ceil(Lp / (2 * threads)), both set by the launch). Any other plan is refused with cudaErrorInvalidValue.
// pair_end: 1 takes the PE builds (a batch of pair-end jobs), 0 the
// ordinary builds.
extern "C" int viterbi_linear_launch(
    const void* ms, const void* gexti, const void* ol, const void* vlox,
    const void* vloy, const void* vhi, const void* fscal,
    const void* iscal, void* codes, void* corner, void* edges, void* flags,
    int B, int D, int Lp, int rows, int threads, int tiled, int pair_end,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (threads < 32 || threads > 1024 || threads % 32 || D < 2 || Lp < 1 ||
      B < 1 || (pair_end != 0 && pair_end != 1) ||
      (tiled != 0 && tiled != 1))
    return (int)cudaErrorInvalidValue;
  Batch a;
  a.ms = (const float*)ms;
  a.gexti = (const float*)gexti;
  a.ol = (const float*)ol;
  a.vlox = (const int*)vlox;
  a.vloy = (const int*)vloy;
  a.vhi = (const int*)vhi;
  a.fscal = (const float*)fscal;
  a.iscal = (const int*)iscal;
  a.codes = (uint8_t*)codes;
  a.corner = (float*)corner;
  a.D = D;
  a.Lp = Lp;
  if (tiled) {
    if (rows != 2 || edges == nullptr || flags == nullptr)
      return (int)cudaErrorInvalidValue;
    const int ntiles = (Lp + 2 * threads - 1) / (2 * threads);
    cudaError_t err = cudaMemsetAsync(codes, 0, (size_t)B * D * Lp, st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(flags, 0, sizeof(int) * (1 + (size_t)B * ntiles),
                            st);
    int dev = 0, sms = 0, per = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    void (*kern)(Batch, float4*, int*, int, int) =
        pair_end ? viterbi_linear_tiles_kernel<true>
                 : viterbi_linear_tiles_kernel<false>;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, threads,
                                                          0);
    if (err != cudaSuccess) return (int)err;
    // a persistent grid: every block resident, none idle past the tickets
    const long tickets = (long)B * ntiles;
    const int grid = (int)(tickets < (long)sms * per ? tickets
                                                      : (long)sms * per);
    kern<<<grid < 1 ? 1 : grid, threads, 0, st>>>(a, (float4*)edges,
                                                  (int*)flags, B, ntiles);
    return (int)cudaGetLastError();
  }
  if (Lp % 32 || (long)rows * threads < Lp) return (int)cudaErrorInvalidValue;
  switch (rows) {
#define LIN_LANES(n)                                                       \
  case n:                                                                  \
    if (pair_end)                                                          \
      viterbi_linear_lanes_kernel<n, true><<<B, threads, 0, st>>>(a);      \
    else                                                                   \
      viterbi_linear_lanes_kernel<n, false><<<B, threads, 0, st>>>(a);     \
    return (int)cudaGetLastError();
    LIN_LANES(1)
    LIN_LANES(2)
#undef LIN_LANES
    default:
      return (int)cudaErrorInvalidValue;
  }
}
