// Kernel E: scaled backward probability planes, anti-diagonals D-1 .. 0.
//
// Replaces the TPU kernel pagan2_tpu/align/fullprob_pallas.py::_bwd_kernel
// (launched by fullprob_bwd_pallas) with its linear entry point, and the
// XLA scan cores pagan2_tpu/align/fullprob.py::_build_bwd_fanin_gather
// and ::_build_bwd_fanin with its fan-in entry point. It writes row d of
// its outputs itself: no reversed input stream, no un-reversal.
//
// Per diagonal d, from the diagonals after it:
//   linear:  xn = bX(i+1, j), yn = bY(i, j+1) of diagonal d+1,
//            T = q(i+1, j+1) of diagonal d+2 times 1/s of d+1, with
//            q = bM * ms2 (all in the units of diagonal d+1)
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
// Invalid cells are 0. The diagonal's maximum s (1 where it is 0)
// divides its three rows, q = M/s * ms, and cum += log(s).
//
// Every operation is one IEEE f32 operation in the order written (build
// flag -fmad=false); sums over slots run in slot order. So the planes
// equal the plain versions' (align/fullprob_fill.py) bit for bit.
//
// What bounds it on an H100: the serial chain of D = L + R - 1
// diagonals of one job, one block (or cluster, item 6) per job. Bytes
// (16 per cell) and operations are hundreds of times below the card's
// rates, so a step costs its barrier, its reduction and its
// instruction issue. The design, per step d:
//  1. One block barrier. Each warp reduces the maximum of its raw cells
//     with shuffles and writes it to a row of warp maxima (two rows,
//     taken in turn by the parity of d); then the one __syncthreads. At
//     the start of step d-1 every warp reduces that row itself, so every
//     thread holds s, 1/s and cum of diagonal d with no second barrier,
//     scales its own lanes of d from registers and writes the planes.
//  2. Raw values in the ring, scales applied on read. X and Y of d
//     enter the ring (fan-in) or the rows in shared memory (linear) raw
//     before the barrier. A reader multiplies a value of diagonal e by
//     1/s of e, e-1, ..., d+1 in turn: the plain version's own sequence
//     of multiplies, once at its rescale and then once a push. q = M/s * ms
//     needs the scale of its own diagonal between two multiplies, so its
//     owner writes it one step late, in the finish of diagonal d+1 at
//     step d: no T read of step d reaches diagonal d+1 (ot = oL + oR >= 2
//     fan-in, 2 linear), so it is read from step d-1 on, after the
//     barrier. Every thread keeps 1/s of d+1 and d+2 in registers; the
//     older ones are in a shared ring of G+1 entries.
//  3. The newest diagonals on chip (fan-in). The ring of q, X and Y is
//     in shared memory when its G+1 diagonals fit ("shared"); else the
//     newest H >= 3 diagonals are there and every diagonal is also
//     written to a global ring of G+1 ("hot": offsets o < H read shared
//     memory, the skip edges of indels the global ring); else global
//     only. Slots advance by counters, no division.
//  4. Inputs on chip or staged ahead. A thread's lanes i = tid + r *
//     threads never change: it loads its left site's forward-edge slots
//     into registers once a launch. The right site j = d - i moves every
//     step, so the job's right-site slot table is copied into shared
//     memory once a launch when it fits beside the ring (else it is read
//     from device memory through the same pointer). The match values of
//     d are loaded before diagonal d is computed (linear: one step
//     earlier still) and the seeds of d-1 after it, so that the loads are
//     in flight across the computation and the barrier.
//  5. Compile-time fan-in (KL, KR up to 4 x 4, or 0 x 0: runtime K) and
//     lanes a thread (ROWS: linear lane builds 1 or 2, cluster build 2
//     or 4, fan-in 2, or 4 up to K 2 x 2; raw values in registers;
//     fan-in 0: any count, raw values kept in the ring slot of d). The
//     slot-0 sources are read without a branch; other slots behind one.
//     Planes are written with streaming stores: nothing here reads them
//     again.
//  6. Linear past the lane builds (bwd_linear_plan's "cluster" build):
//     one thread block cluster of C CTAs a job (2 to 8, 16 with the
//     non-portable opt-in), the lanes split into C ranges of threads x
//     ROWS (2 or 4), each lane in registers as in the lane builds; one
//     cluster barrier a diagonal (release/acquire at cluster scope)
//     instead of the block's. Warp 0 of each CTA gathers its warps'
//     maxima (named barrier 1) and its lanes l < C store the CTA's
//     maximum into the maxima row of CTA l, so every CTA reduces all C
//     maxima itself (max is exact: s bit for bit the one-block s). X and
//     q of lane i read lane i+1, so the owner of a CTA's FIRST
//     lane stores what the CTA before reads there, into that CTA's slot
//     LC: its raw X of d at step d, and its q of d+1 when it writes it,
//     a step late, in the finish at step d; the reader takes q of d+1 at
//     step d-1, after the barrier of step d. Parity rows are enough: a
//     CTA writes step d-2's rows only after every CTA has passed the
//     barrier of step d-1, after its reads of step d-1. A CTA whose lanes
//     lie outside the matrix computes zeros and still arrives at every
//     barrier; CTA 0 writes cum. With two lanes a thread the planes of
//     d+1 are stored between the barrier's arrive and its wait.
// The launch plan (template, lanes a thread, threads, cluster, ring
// placement, right-slot table, shared bytes) is align/fullprob_fill.py::
// bwd_fanin_plan and ::bwd_linear_plan; the kernel only picks the build
// the plan names and refuses a plan it has none for (and a cluster the
// card cannot schedule: launch_cluster asks first).
//
// Ring-slot safety (fan-in). Diagonal e sits in global slot e % (G+1)
// and hot slot e % H. Step d writes X, Y of d (slot of d) and q of d+1
// (slot of d+1); it reads X, Y of e in [d+1, d+G] and q of e in
// [d+2, d+G], the hot ring only for e - d < H. The slot of d last held
// d+G+1 (d+H), the slot of d+1 held d+G+2 (d+H+1): no read of step d
// reaches them. A slot is read before it is first written only as a
// diagonal e >= D, so the zeroed rings give those reads 0, as the plain
// version's empty ring does. A source that is not read (slot 0 with no
// edge) reads X of d+1 at lane i, which step d does not write.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fullprob_common.cuh"

namespace {

// ---------------------------------------------------------------- linear
// ROWS: lanes a thread (lane builds 1 or 2; cluster build 2 or 4),
// raw M, X, Y in registers; the X and q rows of two diagonals (parity of
// d) in shared memory, lane k of the CTA at k. Slot LC (one past the
// CTA's lanes) stays 0 in a lane build and in the cluster's last CTA,
// else holds the first lane of the CTA after it, handed over (item 6).
// CL: the cluster build (grid C B along x, cluster C x 1 x 1: job
// blockIdx.x / C, CTA rank blockIdx.x % C owning lanes rank * nt * ROWS
// on); else one block a job (grid B).
template <int ROWS, bool CL>
__global__ void __launch_bounds__(1024) fullprob_bwd_linear_kernel(
    const float* __restrict__ ms2,     // (B, D, Lp), row d = diagonal d
    const float* __restrict__ consts,  // (B, 8): .. [5] corner seed
    const int* __restrict__ iscal,     // (B, 2): L R
    float* __restrict__ planes,        // (B, 3, D, Lp): M X Y
    float* __restrict__ cum,           // (B, D)
    int D, int Lp) {
  // maxima of a diagonal, a row a parity: 32 warps' a block, or C CTAs'
  // a cluster (and wloc, the CTA's warp maxima of the step)
  constexpr int WS = CL ? CLUSTER_MAX : 32;
  extern __shared__ float smem[];
  __shared__ float wmax[2 * WS];
  __shared__ float wloc[CL ? 32 : 1];
  const int C = CL ? cluster_ctas() : 1;
  const int b = blockIdx.x / C, rank = blockIdx.x % C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nw = (nt + 31) >> 5;
  const int LC = CL ? nt * ROWS : Lp;   // the CTA's lanes
  const int base = rank * LC;           // its first lane
  const int LS = LC + 1;
  // [X of parity 0, 1][q of parity 0, 1][LS]
  float* xb = smem;
  float* qb = smem + 2 * LS;
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

  for (int q = tid; q < 4 * LS; q += nt) smem[q] = 0.0f;
  // raw M, X of diagonal d+1; Y of d+1, scaled in the finish; the
  // match values of d+1 (for the finish) and of d (loaded a step early)
  float Mr[ROWS], Xr[ROWS], Yr[ROWS], msn[ROWS], msn2[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = base + tid + r * nt;
    Mr[r] = Xr[r] = Yr[r] = msn[r] = 0.0f;
    msn2[r] = i < Lp ? __ldg(msb + (size_t)(D - 1) * Lp + i) : 0.0f;
  }
  float cumv = 0.0f;
  float inv1 = 1.0f;   // 1/s of diagonal d+1
  // the cluster: every CTA's copy of the maxima rows (this lane's CTA
  // for lanes l < C) and the CTA before this one's X and q rows, for
  // the hand-over
  float* wrem = wmax;
  float* prev = nullptr;
  if constexpr (CL) {
    wrem = peer(wmax, (tid & 31) < C ? (tid & 31) : 0);
    if (rank > 0) prev = peer(smem, rank - 1);
    // every CTA has started and cleared its rows before any peer stores
    cluster_sync();
  } else {
    __syncthreads();
  }

  // scale the lanes of diagonal e = d+1 (raw maxima in wmax row pe) into
  // Ps, Qs, Ss, write (with q) its q row; store writes them to the
  // planes, and cum. DEFER: the cluster build of two lanes a thread
  // stores them while the barrier of step d completes (with four, the
  // registers they hold past the step spilled)
  constexpr bool DEFER = CL && ROWS == 2;
  float Ps[ROWS], Qs[ROWS], Ss[ROWS];
  auto finish = [&](int e, int pe, bool with_q) {
    float s = CL ? cluster_row_max(wmax + WS * pe, C)
                 : row_max(wmax + WS * pe, nw);
    if (!(s > 0.0f)) s = 1.0f;
    inv1 = 1.0f / s;
    cumv = cumv + logf(s);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int k = tid + r * nt;
      const int i = base + k;
      if (i >= Lp) continue;
      const float Ms = Mr[r] * inv1, Xs = Xr[r] * inv1, Ys = Yr[r] * inv1;
      Ps[r] = Ms;
      Qs[r] = Xs;
      Ss[r] = Ys;
      if (with_q) {
        const float q = Ms * msn[r];
        qb[(e & 1) * LS + k] = q;
        // the CTA's first lane is the previous CTA's lane LC
        if (CL && k == 0 && prev != nullptr)
          prev[2 * LS + (e & 1) * LS + LC] = q;
      }
      Yr[r] = Ys;
    }
  };
  auto store = [&](int e) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = base + tid + r * nt;
      if (i >= Lp) continue;
      __stcs(pM + (size_t)e * Lp + i, Ps[r]);
      __stcs(pX + (size_t)e * Lp + i, Qs[r]);
      __stcs(pY + (size_t)e * Lp + i, Ss[r]);
    }
    if (tid == 0 && rank == 0) cb[e] = cumv;
  };

  for (int d = D - 1; d >= 0; --d) {
    const int par = d & 1;
    if (d + 1 < D) {
      finish(d + 1, par ^ 1, true);
      if constexpr (!DEFER) store(d + 1);
    }
    const float* xn_row = xb + (par ^ 1) * LS;   // raw X of d+1
    const float* q_row = qb + par * LS;          // q of d+2
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = base + tid + r * nt;
      msn[r] = msn2[r];
      msn2[r] = i < Lp && d > 0
                    ? __ldg(msb + (size_t)(d - 1) * Lp + i) : 0.0f;
    }
    float lmax = 0.0f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int k = tid + r * nt;
      const int i = base + k;
      const int j = d - i;
      float M = 0.0f, X = 0.0f, Y = 0.0f;
      if (j >= 0 && j < R && i < L) {
        const float xn = xn_row[k + 1] * inv1;
        const float T = q_row[k + 1] * inv1;
        const float yn = Yr[r];
        const float ex = ext * xn, ey = ext * yn;
        const float gx = gcgo * xn, gy = gcgo * yn;
        const float gt = gcng * T;
        X = (ex + gy) + gt;
        Y = (ey + gx) + gt;
        const float nx = nggo * xn, ny = nggo * yn;
        M = (nx + ny) + ng2 * T;
        if (d == cornerd && i == L - 1) M = M + seed;
      }
      if (i < Lp) {
        xb[par * LS + k] = X;
        if (CL && k == 0 && prev != nullptr) prev[par * LS + LC] = X;
      }
      Mr[r] = M; Xr[r] = X; Yr[r] = Y;
      lmax = fmaxf(lmax, fmaxf(fmaxf(M, X), Y));
    }
    if constexpr (CL) {
      cta_max_to_cluster(lmax, wloc, wrem + WS * par, rank, C);
      cluster_arrive();
      if (DEFER && d + 1 < D) store(d + 1);   // no peer reads the planes
      cluster_wait();
    } else {
      warp_max(lmax, wmax + WS * par);
      __syncthreads();
    }
  }
  // diagonal 0; the barrier of step 0 was the last: no peer stores into
  // this CTA after it, so it may exit
  finish(0, 0, false);
  store(0);
}

// ---------------------------------------------------------------- fan-in
struct FaninArgs {
  const float* msp;     // (B, D, Lp)
  const int* lfoff;     // (B, Lp, KL) forward-edge offsets (0: none)
  const float* lfw;     // (B, Lp, KL)
  const int* rfoff;     // (B, Rr, KR)
  const float* rfw;     // (B, Rr, KR)
  const float* consts;  // (B, 8): .. [6] exp clip limit
  const int* iscal;     // (B, 2)
  const float* seed;    // (B, Gs, Lp)
  float* planes;        // (B, 3, D, Lp)
  float* cum;           // (B, D)
  float* gring;         // (B, 3, G + 1, Lp) when H < G + 1
  int D, Lp, Rr, KL, KR, G, Gs;
  int H;                // diagonals kept in shared memory (G + 1: all)
  int rtab;             // 1: the right-slot table copied to shared memory
};

// KLT, KRT: the fan-in, or 0 for runtime K. ROWS: lanes a thread, raw
// values in registers (0: any count, raw values in the ring slot of d).
// ALLSH: the whole ring in shared memory (H == G + 1). MAXT: the largest
// block it is launched with (sets the register budget).
template <int KLT, int KRT, int ROWS, bool ALLSH, int MAXT>
__global__ void __launch_bounds__(MAXT) fullprob_bwd_fanin_kernel(
    FaninArgs a) {
  constexpr int NL = KLT > 0 ? KLT : 1;
  constexpr int RR = ROWS > 0 ? ROWS : 1;
  extern __shared__ float sh[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nw = (nt + 31) >> 5;
  const int D = a.D, Lp = a.Lp, G = a.G, GR = a.G + 1, H = a.H, Gs = a.Gs;
  const int KL = KLT > 0 ? KLT : a.KL;
  const int KR = KRT > 0 ? KRT : a.KR;
  const int nrows = ROWS > 0 ? ROWS : (Lp + nt - 1) / nt;
  // shared: warp maxima [2][32], 1/s ring [G+1], hot ring [q, X, Y][H][Lp],
  // then (rtab) the right-site slot offsets and weights [Rr][KR]
  float* wmax = sh;
  float* invh = sh + 64;
  float* hot = invh + GR;
  const size_t HS = (size_t)H * Lp;
  const size_t GS = (size_t)GR * Lp;
  float* gr = ALLSH ? nullptr : a.gring + (size_t)b * 3 * GS;
  const float ext = a.consts[b * 8 + 0];
  const float gcgo = a.consts[b * 8 + 1];
  const float nggo = a.consts[b * 8 + 2];
  const float ng2 = a.consts[b * 8 + 3];
  const float gcng = a.consts[b * 8 + 4];
  const float clim = a.consts[b * 8 + 6];
  const int L = a.iscal[b * 2 + 0];
  const int R = a.iscal[b * 2 + 1];
  const int cornerd = L + R - 2;
  const float* mb = a.msp + (size_t)b * D * Lp;
  const int* lo_g = a.lfoff + (size_t)b * Lp * KL;
  const float* lw_g = a.lfw + (size_t)b * Lp * KL;
  const int* ro_g = a.rfoff + (size_t)b * a.Rr * KR;
  const float* rw_g = a.rfw + (size_t)b * a.Rr * KR;
  int* rso_s = reinterpret_cast<int*>(hot + 3 * HS);
  float* rsw_s = reinterpret_cast<float*>(rso_s + (size_t)a.Rr * KR);
  const int* rso = a.rtab ? rso_s : ro_g;
  const float* rsw = a.rtab ? rsw_s : rw_g;
  const float* sb = a.seed + (size_t)b * Gs * Lp;
  float* pM = a.planes + ((size_t)b * 3 + 0) * D * Lp;
  float* pX = a.planes + ((size_t)b * 3 + 1) * D * Lp;
  float* pY = a.planes + ((size_t)b * 3 + 2) * D * Lp;
  float* cb = a.cum + (size_t)b * D;

  for (size_t q = tid; q < 3 * HS; q += nt) hot[q] = 0.0f;
  if constexpr (!ALLSH)
    for (size_t q = tid; q < 3 * GS; q += nt) gr[q] = 0.0f;
  for (int g = tid; g < GR; g += nt) invh[g] = 1.0f;
  if (a.rtab) {
    for (int q = tid; q < a.Rr * KR; q += nt) {
      rso_s[q] = __ldg(ro_g + q);
      rsw_s[q] = __ldg(rw_g + q);
    }
  }

  // a left slot with no edge, or whose source lane is past Lp, holds 0
  auto left_off = [&](int i, int k) -> int {
    const int o = __ldg(lo_g + (size_t)i * KL + k);
    return (o > 0 && i + o < Lp) ? o : 0;
  };
  // the lanes' left-site slots, once a launch
  int lo[RR][NL];
  float lw[RR][NL];
  if constexpr (KLT > 0) {
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const int i = tid + r * nt;
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        lo[r][k] = i < Lp ? left_off(i, k) : 0;
        lw[r][k] = i < Lp ? __ldg(lw_g + (size_t)i * KL + k) : 0.0f;
      }
    }
  }
  // staged for step d: the seeds of d; for the finish at step d: the
  // match values of d+1
  float sdv[RR], msn[RR];
  // raw M, X, Y of diagonal d+1 (ROWS > 0)
  float Mr[RR], Xr[RR], Yr[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r)
    sdv[r] = msn[r] = Mr[r] = Xr[r] = Yr[r] = 0.0f;
  auto stage = [&](int dd) {
    const int sidx = cornerd - dd;
    if constexpr (ROWS > 0) {
      if (sidx >= 0 && sidx < Gs) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int i = tid + r * nt;
          sdv[r] = i < Lp ? __ldg(sb + (size_t)sidx * Lp + i) : 0.0f;
        }
      }
    }
  };
  stage(D - 1);

  float cum1 = 0.0f;               // cum of diagonal d+1
  float inv1 = 1.0f, inv2 = 1.0f;  // 1/s of diagonals d+1, d+2
  int sg = (D - 1) % GR;           // slot of d, global ring and invh
  int shs = H > 0 ? (D - 1) % H : 0;   // slot of d, hot ring
  __syncthreads();

  // the finish of diagonal e = d+1 (global slot g1, hot slot h1): s
  // from warp-maxima row pe, its lanes scaled, planes, cum, q
  auto finish = [&](int e, int pe, int g1, int h1, bool with_q) {
    float s = row_max(wmax + 32 * pe, nw);
    if (!(s > 0.0f)) s = 1.0f;
    const float inv = 1.0f / s;
    inv2 = inv1;
    inv1 = inv;
    cum1 = cum1 + logf(s);
    // ROWS == 0: raw values wait in the slot of e of the ring that
    // holds every diagonal
    const float* raw = ALLSH ? hot + (size_t)h1 * Lp : gr + (size_t)g1 * Lp;
    const size_t RS = ALLSH ? HS : GS;
#pragma unroll
    for (int r = 0; r < (ROWS > 0 ? ROWS : nrows); ++r) {
      const int i = tid + r * nt;
      if (i >= Lp) continue;
      float M, X, Y, ms;
      if constexpr (ROWS > 0) {
        M = Mr[r]; X = Xr[r]; Y = Yr[r]; ms = msn[r];
      } else {
        M = raw[i];
        X = raw[RS + i];
        Y = raw[2 * RS + i];
        ms = with_q ? __ldg(mb + (size_t)e * Lp + i) : 0.0f;
      }
      const float Ms = M * inv;
      __stcs(pM + (size_t)e * Lp + i, Ms);
      __stcs(pX + (size_t)e * Lp + i, X * inv);
      __stcs(pY + (size_t)e * Lp + i, Y * inv);
      if (with_q) {
        const float q = Ms * ms;
        if (H > 0) hot[(size_t)h1 * Lp + i] = q;
        if constexpr (!ALLSH) gr[(size_t)g1 * Lp + i] = q;
      }
    }
    if (tid == 0) {
      cb[e] = cum1;
      invh[g1] = inv;
    }
  };

  for (int d = D - 1; d >= 0; --d) {
    const int par = d & 1;
    const int g1 = sg + 1 == GR ? 0 : sg + 1;
    const int h1 = shs + 1 >= H ? 0 : shs + 1;
    if (d + 1 < D) finish(d + 1, par ^ 1, g1, h1, true);

    // value of matrix mat (0 q, 1 X, 2 Y) of diagonal d+o at `lane`,
    // as stored (1 <= o <= G)
    auto rd = [&](int mat, int o, int lane) -> float {
      int hs = shs + o;
      hs -= hs >= H ? H : 0;
      if constexpr (ALLSH) {
        return hot[mat * HS + (size_t)hs * Lp + lane];
      } else {
        if (o < H) return hot[mat * HS + (size_t)hs * Lp + lane];
        int gs = sg + o;
        gs -= gs >= GR ? GR : 0;
        return gr[mat * GS + (size_t)gs * Lp + lane];
      }
    };
    // v times 1/s of diagonals d+n, d+n-1, ..., d+1, in that order
    auto scale = [&](float v, int n) -> float {
      if (n >= 3) {
        int s = sg + n;
        s -= s >= GR ? GR : 0;
        for (int t = n; t >= 3; --t) {
          v = v * invh[s];
          s = s == 0 ? GR - 1 : s - 1;
        }
      }
      if (n >= 2) v = v * inv2;
      return v * inv1;
    };

    const int sidx = cornerd - d;
    const bool seeded = sidx >= 0 && sidx < Gs;
    const float unscale =
        seeded ? expf(-fminf(fmaxf(cum1, -clim), clim)) : 0.0f;
    // ROWS == 0: raw values of d go to the slot of d of the ring that
    // holds every diagonal (its q row is read from step d-2 on, after
    // the finish of d has put q there)
    float* raw = ALLSH ? hot + (size_t)shs * Lp : gr + (size_t)sg * Lp;
    if constexpr (ROWS > 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = tid + r * nt;
        if (i < Lp) msn[r] = __ldg(mb + (size_t)d * Lp + i);
      }
    }
    float lmax = 0.0f;
#pragma unroll
    for (int r = 0; r < (ROWS > 0 ? ROWS : nrows); ++r) {
      const int i = tid + r * nt;
      const int j = d - i;
      auto lof = [&](int k) -> int {
        if constexpr (KLT > 0) return lo[r][k];
        else return left_off(i, k);
      };
      auto lwf = [&](int k) -> float {
        if constexpr (KLT > 0) return lw[r][k];
        else return __ldg(lw_g + (size_t)i * KL + k);
      };
      auto rof = [&](int k) -> int { return rso[(size_t)j * KR + k]; };
      auto rwf = [&](int k) -> float { return rsw[(size_t)j * KR + k]; };
      float M = 0.0f, X = 0.0f, Y = 0.0f;
      if (j >= 0 && j < R && i < L) {
        // slot 0 of each side and the pair (0, 0), read together
        // without a branch; a source that does not exist reads X of d+1
        // at lane i and contributes 0
        const int ol0 = lof(0), or0 = rof(0);
        const bool okA = ol0 > 0 && ol0 <= G;
        const bool okB = or0 > 0 && or0 <= G;
        const bool okT = ol0 > 0 && or0 > 0 && ol0 + or0 <= G;
        const float va = rd(1, okA ? ol0 : 1, okA ? i + ol0 : i);
        const float vb = rd(okB ? 2 : 1, okB ? or0 : 1, i);
        const float vt = rd(okT ? 0 : 1, okT ? ol0 + or0 : 1,
                            okT ? i + ol0 : i);
        float A = 0.0f, Bs = 0.0f, T = 0.0f;
        A = A + (okA ? scale(va, ol0) : 0.0f);
#pragma unroll
        for (int k = 1; k < KL; ++k) {
          const int o = lof(k);
          if (o > 0 && o <= G) A = A + scale(rd(1, o, i + o), o);
        }
        Bs = Bs + (okB ? scale(vb, or0) : 0.0f);
#pragma unroll
        for (int k = 1; k < KR; ++k) {
          const int o = rof(k);
          if (o > 0 && o <= G) Bs = Bs + scale(rd(2, o, i), o);
        }
        if (okT) T = T + (scale(vt, ol0 + or0 - 1) * lwf(0)) * rwf(0);
#pragma unroll
        for (int kl = 0; kl < KL; ++kl) {
          const int ol = lof(kl);
          if (ol <= 0) continue;
          const float wl = lwf(kl);
#pragma unroll
          for (int kr = kl == 0 ? 1 : 0; kr < KR; ++kr) {
            const int orr = rof(kr);
            const int ot = ol + orr;
            if (!(orr > 0 && ot <= G)) continue;
            T = T + (scale(rd(0, ot, i + ol), ot - 1) * wl) * rwf(kr);
          }
        }
        const float ea = ext * A, eb = ext * Bs;
        const float ga = gcgo * A, gb = gcgo * Bs;
        const float gt = gcng * T;
        X = (ea + gb) + gt;
        Y = (eb + ga) + gt;
        const float na = nggo * A, nb = nggo * Bs;
        M = (na + nb) + ng2 * T;
        if (seeded) {
          float sv;
          if constexpr (ROWS > 0) sv = sdv[r];
          else sv = __ldg(sb + (size_t)sidx * Lp + i);
          M = M + sv * unscale;
        }
      }
      if (i < Lp) {
        if (H > 0) {
          hot[HS + (size_t)shs * Lp + i] = X;
          hot[2 * HS + (size_t)shs * Lp + i] = Y;
        }
        if constexpr (!ALLSH) {
          gr[GS + (size_t)sg * Lp + i] = X;
          gr[2 * GS + (size_t)sg * Lp + i] = Y;
        }
        if constexpr (ROWS == 0) raw[i] = M;
      }
      if constexpr (ROWS > 0) {
        Mr[r] = M; Xr[r] = X; Yr[r] = Y;
      }
      lmax = fmaxf(lmax, fmaxf(fmaxf(M, X), Y));
    }
    if (d > 0) stage(d - 1);
    warp_max(lmax, wmax + 32 * par);
    __syncthreads();
    sg = sg == 0 ? GR - 1 : sg - 1;
    if (H > 0) shs = shs == 0 ? H - 1 : shs - 1;
  }
  // diagonal 0: its slots are the ones after the slot counters
  finish(0, 0, sg + 1 == GR ? 0 : sg + 1, shs + 1 >= H ? 0 : shs + 1,
         false);
}

// the fan-in kernel, as fullprob_common.cuh's dispatch takes it
struct FaninBuilds {
  using Args = FaninArgs;
  template <int KLT, int KRT, int ROWS, bool ALLSH, int MAXT>
  static auto kernel() {
    return fullprob_bwd_fanin_kernel<KLT, KRT, ROWS, ALLSH, MAXT>;
  }
};

}  // namespace

// The linear plan, as fullprob_fill.py::bwd_linear_plan computes it:
// rows: lanes a thread; cluster: 0 for a lane build (one block a job,
// rows 1 or 2, rows x threads >= Lp), else the CTAs of the job's
// cluster (2 to 16, rows 2 or 4, cluster x rows x threads >= Lp);
// smem: the X and q rows of two diagonals, 16 bytes a lane of the block
// or CTA and one more.
extern "C" int fullprob_bwd_linear_launch(
    const void* ms2, const void* consts, const void* iscal, void* planes,
    void* cum, int B, int D, int Lp, int rows, int cluster, int threads,
    int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long lanes = (long)rows * threads * (cluster ? cluster : 1);
  if (threads < 32 || threads > 1024 || threads % 32 || lanes < Lp ||
      B < 1 ||
      (size_t)smem < (size_t)4 * ((cluster ? rows * threads : Lp) + 1) *
                         sizeof(float))
    return (int)cudaErrorInvalidValue;
  const float* m = (const float*)ms2;
  const float* c = (const float*)consts;
  const int* is = (const int*)iscal;
  float* p = (float*)planes;
  float* cu = (float*)cum;
  cudaError_t err;
  if (cluster) {
    switch (rows) {
      case 2:
        return launch_cluster(fullprob_bwd_linear_kernel<2, true>, cluster,
                              B, threads, (size_t)smem, st, m, c, is, p, cu,
                              D, Lp);
      case 4:
        return launch_cluster(fullprob_bwd_linear_kernel<4, true>, cluster,
                              B, threads, (size_t)smem, st, m, c, is, p, cu,
                              D, Lp);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (rows) {
#define BWD_LIN(n)                                                          \
  case n:                                                                   \
    err = allow_smem(fullprob_bwd_linear_kernel<n, false>, (size_t)smem);   \
    if (err != cudaSuccess) return (int)err;                                \
    fullprob_bwd_linear_kernel<n, false><<<B, threads, smem, st>>>(         \
        m, c, is, p, cu, D, Lp);                                            \
    return (int)cudaGetLastError();
    BWD_LIN(1)
    BWD_LIN(2)
#undef BWD_LIN
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of the cluster build (rows 2 or 4) of `cluster`
// CTAs of `threads` threads and smem bytes the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the error of the query.
extern "C" int fullprob_bwd_linear_clusters(int rows, int cluster,
                                            int threads, int smem) {
  if (rows == 2)
    return cluster_fit(fullprob_bwd_linear_kernel<2, true>, cluster,
                       threads, (size_t)smem);
  if (rows == 4)
    return cluster_fit(fullprob_bwd_linear_kernel<4, true>, cluster,
                       threads, (size_t)smem);
  return -(int)cudaErrorInvalidValue;
}

// The fan-in plan, as fullprob_fill.py::bwd_fanin_plan computes it:
// hot: diagonals kept in shared memory (G + 1: the whole ring; fewer:
// all of them also in gring; 0: gring only); klt, krt: the templated
// fan-in (0, 0: runtime K); rows: lanes a thread (2, or 4 up to a
// templated K 2 x 2; 0: any count, runtime K only); threads: the
// block; smem: dynamic shared bytes (warp maxima, 1/s ring, hot ring
// and, with rtab, the right-slot table); rtab: 1 copies the table to
// shared memory, 0 reads it from device memory.
extern "C" int fullprob_bwd_fanin_launch(
    const void* msp, const void* lfoff, const void* lfw, const void* rfoff,
    const void* rfw, const void* consts, const void* iscal,
    const void* seed, void* planes, void* cum, void* gring, int B, int D,
    int Lp, int Rr, int KL, int KR, int G, int Gs, int hot, int rtab,
    int klt, int krt, int rows, int threads, int smem, void* stream) {
  FaninArgs a;
  a.msp = (const float*)msp;
  a.lfoff = (const int*)lfoff;
  a.lfw = (const float*)lfw;
  a.rfoff = (const int*)rfoff;
  a.rfw = (const float*)rfw;
  a.consts = (const float*)consts;
  a.iscal = (const int*)iscal;
  a.seed = (const float*)seed;
  a.planes = (float*)planes;
  a.cum = (float*)cum;
  a.gring = (float*)gring;
  a.D = D;
  a.Lp = Lp;
  a.Rr = Rr;
  a.KL = KL;
  a.KR = KR;
  a.G = G;
  a.Gs = Gs;
  a.H = hot;
  a.rtab = rtab != 0;
  if (G < 1 || hot < 0 || hot > G + 1 || (hot <= G && gring == nullptr) ||
      threads < 32 || threads % 32 ||
      (rows > 0 && (long)rows * threads < Lp) ||
      (size_t)smem < ((size_t)64 + G + 1 + (size_t)3 * hot * Lp +
                      (a.rtab ? (size_t)2 * Rr * KR : 0)) * 4)
    return (int)cudaErrorInvalidValue;
  return dispatch<FaninBuilds>(a, klt, krt, B, rows, threads,
                               (size_t)smem, (cudaStream_t)stream);
}
