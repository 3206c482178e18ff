// Kernel D: scaled forward probability planes, anti-diagonals 0 .. D-1.
//
// Replaces the TPU kernel pagan2_tpu/align/fullprob_pallas.py::_fwd_kernel
// (launched by fullprob_fwd_pallas) with its linear entry point, and the
// XLA scan cores pagan2_tpu/align/fullprob.py::_build_fwd_fanin_gather
// and ::_build_fwd_fanin with its fan-in entry point.
//
// Per diagonal d = i + j, from the diagonals before it:
//   linear:  X(i,j) = (ext x1[i-1] + gcgo y1[i-1]) + nggo m1[i-1]
//            Y(i,j) = (ext y1[i]   + gcgo x1[i])   + nggo m1[i]
//            M(i,j) = ms2[d][i] ((ng2 m2[i-1] + gcng x2[i-1]) + gcng y2[i-1])
//   with (m1,x1,y1) diagonal d-1 and (m2,x2,y2) diagonal d-2, both in the
//   units of diagonal d-1; ms2 = (msp wl[i]) wr[j] folded by the caller.
//   fan-in:  X sums over the left site's BACKWARD-edge slots k with
//            offset o: the same combination read at diagonal d-o, lane
//            i-o, no weight; Y over the right site's slots at diagonal
//            d-o, lane i; M = msp[d][i] * sum over slot pairs (kl, kr) of
//            ((ng2 m + gcng x) + gcng y) at diagonal d-oL-oR, lane i-oL,
//            times lw then rw.
// Invalid cells are 0. The diagonal's maximum s (1 where it is 0)
// divides its three rows, and cum[d] = cum[d-1] + log(s): a stored value
// times exp(cum[d]) is the true forward probability.
//
// Every operation is one IEEE f32 operation in the order written (build
// flag -fmad=false); sums over slots run in slot order. So the planes
// equal the plain versions' (align/fullprob_fill.py) bit for bit.
//
// What bounds it on an H100: the serial chain of D = L + R - 1
// diagonals of one job, one block (or cluster, item 6) per job. Bytes
// (16 per cell) and operations are hundreds of times below the card's
// rates, so a step costs its barrier, its reduction and its
// instruction issue. The design (kernel E's, csrc/fullprob_bwd.cu, run
// forward), per step d:
//  1. One block barrier. Each warp reduces the maximum of its raw cells
//     with shuffles and writes it to a row of warp maxima (two rows,
//     taken in turn by the parity of d); then the one __syncthreads. At
//     the start of step d+1 every warp reduces that row itself, so every
//     thread holds s, 1/s and cum of diagonal d with no second barrier,
//     scales its own lanes of d from registers and writes the planes
//     with streaming stores (nothing here reads them again). Diagonal
//     D-1 is finished after the loop; diagonal 0 (M(0,0) = 1) enters as
//     a raw diagonal whose maximum is 1.
//  2. Raw values stored, scales applied on read. M, X and Y of d enter
//     the ring (fan-in) or the row buffers (linear) raw, before the
//     barrier. A reader at step d multiplies a value of diagonal e by
//     1/s of e, e+1, ..., d-1 in that order: the plain version's own
//     sequence of multiplies, its rescale once and then once a push. D's
//     match value multiplies after the slot sum, so nothing is written a
//     step late (unlike E's q). Every offset is >= 1 (oL + oR >= 2 for
//     M), so every read of step d reaches diagonals finished before its
//     barrier. Every thread keeps 1/s of d-1 and d-2 in registers; the
//     older ones are in a shared ring of G+1 entries.
//  3. Linear: X reads lane i-1 of d-1, Y lane i of d-1 (the thread's own,
//     in registers) and M lane i-1 of d-2. The neighbour's raw M, X, Y of
//     d-1 are read once, used for X at step d and kept in registers for
//     M at step d+1, so shared memory holds only the rows of the two
//     newest diagonals, taken in turn by parity, M, X and Y of a lane in
//     one 16-byte slot (32 (lanes + 1) bytes, lanes of the block or of
//     the CTA). ms2 of d+1 is loaded during step d.
//  4. Fan-in: the newest diagonals on chip. The ring holds raw M, X, Y
//     of a lane in one 16-byte slot (one load and one address a source,
//     one store a cell). It is in
//     shared memory when its G+1 diagonals fit ("shared"); else the
//     newest H >= 3 diagonals are there and every diagonal is also
//     written to a global ring of G+1 ("hot": offsets o < H read shared
//     memory, the skip edges of indels the global ring); else global
//     only. Slots advance by counters, no division. A thread's lanes
//     i = tid + r * threads never change: it loads its left site's
//     backward-edge slots into registers once a launch. The right site
//     j = d - i moves every step, so the job's right-site slot table is
//     copied into shared memory once a launch when it fits beside the
//     ring (else it is read from device memory through the same
//     pointer). msp of d+1 is loaded during step d.
//  5. Compile-time fan-in (KL, KR up to 4 x 4, or 0 x 0: runtime K) and
//     lanes a thread (ROWS: linear lane builds 1 or 2, cluster build 2
//     or 4, fan-in 2, or 4 up to K 2 x 2; raw values in registers;
//     fan-in 0: any count, raw values read back from the ring slot of
//     d). The slot-0 sources are read without a branch; other slots
//     behind one.
//  6. Linear past the lane builds (fwd_linear_plan's "cluster" build):
//     one thread block cluster of C CTAs a job (2 to 8, 16 with the
//     non-portable opt-in; neighbouring SMs), the lanes split into C
//     ranges of threads x ROWS (2 or 4), each lane in registers as in
//     the lane builds. The block barrier becomes one cluster barrier a
//     diagonal (release/acquire at cluster scope). Before it, each warp
//     reduces its maximum with shuffles, warp 0 of the CTA gathers them
//     (named barrier 1) and its lanes l < C store the CTA's maximum
//     into the maxima row of CTA l (distributed shared memory), so every
//     CTA holds all C maxima of d and reduces them itself at step d+1:
//     max is exact, so s is the one-block s bit for bit (C remote stores
//     a CTA and diagonal: on the H100 a store a warp and CTA took 7%
//     (D) and 12% (E) longer at 16 CTAs of 544 threads, and the same
//     within 7% at 8 CTAs of 320 to 384). The owner of a CTA's last lane
//     also stores its raw (M, X, Y) of d into slot 0 (lane -1) of the
//     next CTA's row of d's parity. Parity rows are enough: a CTA writes
//     step d+2's rows only after every CTA has passed the barrier of
//     step d+1, after its reads of step d+1. A CTA whose lanes lie
//     outside the matrix on a diagonal computes zeros and still arrives
//     at every barrier; CTA 0 writes cum. With two lanes a thread the
//     planes of d-1 are stored between the barrier's arrive and its wait.
// The launch plan (template, lanes a thread, threads, cluster, ring
// placement, right-slot table, shared bytes) is align/fullprob_fill.py::
// fwd_fanin_plan and ::fwd_linear_plan; the kernel only picks the build
// the plan names and refuses a plan it has none for (and a cluster the
// card cannot schedule: launch_cluster asks first).
//
// Ring-slot safety (fan-in). Diagonal e sits in global slot e % (G+1)
// and hot slot e % H. Step d writes M, X, Y of d (the slot of d) and
// reads e in [d-G, d-1], the hot ring only for d - e < H. The slot of d
// last held d-G-1 (d-H): no read of step d reaches it. A read of a
// diagonal e < 0 finds a slot not yet written, which holds 0, as the
// plain version's empty ring does. A source that is not read (slot 0
// with no edge) reads diagonal d-1 at lane i and contributes 0. The 1/s
// of d-1 enters its ring slot at step d; reads of step d take 1/s of
// d-3 and older from the ring.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fullprob_common.cuh"

namespace {

// ---------------------------------------------------------------- linear
// ROWS: lanes a thread (lane builds 1 or 2; cluster build 2 or 4);
// raw M, X, Y of d-1 at lane i and of d-2 at lane i-1 in registers, the
// rows of two generations (parity of d) in shared memory. A row holds
// (M, X, Y, 0) of the CTA's lane k at k + 1; its slot 0 holds lane -1
// (0) in a lane build and in the cluster's first CTA, else the last
// lane of the CTA before it, handed over (item 6). CL: the cluster
// build (grid C B along x, cluster C x 1 x 1: job blockIdx.x / C, CTA
// rank blockIdx.x % C owning lanes rank * nt * ROWS on); else one block
// a job (grid B).
template <int ROWS, bool CL>
__global__ void __launch_bounds__(1024) fullprob_fwd_linear_kernel(
    const float* __restrict__ ms2,     // (B, D, Lp), row d = diagonal d
    const float* __restrict__ consts,  // (B, 8)
    const int* __restrict__ iscal,     // (B, 2): L R
    float* __restrict__ planes,        // (B, 3, D, Lp): M X Y
    float* __restrict__ cum,           // (B, D)
    int D, int Lp) {
  // maxima of a diagonal, a row a parity: 32 warps' a block, or C CTAs'
  // a cluster (and wloc, the CTA's warp maxima of the step)
  constexpr int WS = CL ? CLUSTER_MAX : 32;
  extern __shared__ float4 rows4[];
  __shared__ float wmax[2 * WS];
  __shared__ float wloc[CL ? 32 : 1];
  const int C = CL ? cluster_ctas() : 1;
  const int b = blockIdx.x / C, rank = blockIdx.x % C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nw = (nt + 31) >> 5;
  const int LC = CL ? nt * ROWS : Lp;   // the CTA's lanes
  const int base = rank * LC;           // its first lane
  const int LS = LC + 1;                // a generation's row
  float4* buf = rows4;
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

  // generation 0 is diagonal 0: raw M(0, 0) = 1, all else 0
  for (int q = tid; q < 2 * LS; q += nt)
    buf[q] = make_float4(q == 1 && base == 0 ? 1.0f : 0.0f, 0.0f, 0.0f,
                         0.0f);
  // raw M, X, Y of d-1 at lane i; raw M, X, Y of d-2 at lane i-1; ms2 of
  // d, loaded a step early
  float Mr[ROWS], Xr[ROWS], Yr[ROWS], pm[ROWS], px[ROWS], py[ROWS],
      msn[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = base + tid + r * nt;
    Mr[r] = Xr[r] = Yr[r] = pm[r] = px[r] = py[r] = 0.0f;
    msn[r] = i < Lp ? __ldg(msb + Lp + i) : 0.0f;
  }
  if (base == 0 && tid == 0) Mr[0] = 1.0f;
  float cumv = 0.0f;
  float inv1 = 1.0f, inv2 = 1.0f;   // 1/s of diagonals d-1, d-2
  // the cluster: every CTA's copy of the maxima rows (this lane's CTA
  // for lanes l < C) and the next CTA's rows, for the hand-over
  float* wrem = wmax;
  float4* next = nullptr;
  if constexpr (CL) {
    wrem = peer(wmax, (tid & 31) < C ? (tid & 31) : 0);
    if (rank + 1 < C) next = peer(buf, rank + 1);
    // diagonal 0's maximum is 1 (lane 0)
    for (int q = tid; q < 2 * WS; q += nt) wmax[q] = q == 0 ? 1.0f : 0.0f;
    // every CTA has started and set its rows before any peer stores
    cluster_sync();
  } else {
    warp_max(tid == 0 ? 1.0f : 0.0f, wmax);
    __syncthreads();
  }

  // scale the lanes of diagonal e (raw maxima in wmax row e & 1) into
  // Ps, Qs, Ss; store writes them to the planes, and cum. DEFER: the
  // cluster build of two lanes a thread stores them while its barrier of
  // the next step completes (with four, the 12 registers they hold past
  // the step spilled)
  constexpr bool DEFER = CL && ROWS == 2;
  float Ps[ROWS], Qs[ROWS], Ss[ROWS];
  auto scale = [&](int e) {
    float s = CL ? cluster_row_max(wmax + WS * (e & 1), C)
                 : row_max(wmax + WS * (e & 1), nw);
    if (!(s > 0.0f)) s = 1.0f;
    const float inv = 1.0f / s;
    inv2 = inv1;
    inv1 = inv;
    cumv = cumv + logf(s);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      Ps[r] = Mr[r] * inv;
      Qs[r] = Xr[r] * inv;
      Ss[r] = Yr[r] * inv;
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

  for (int d = 1; d < D; ++d) {
    const float4* nb = buf + ((d - 1) & 1) * LS;   // d-1
    float4* wb = buf + (d & 1) * LS;               // d
    scale(d - 1);
    if constexpr (!DEFER) store(d - 1);
    float ms[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = base + tid + r * nt;
      ms[r] = msn[r];
      msn[r] = i < Lp && d + 1 < D
                   ? __ldg(msb + (size_t)(d + 1) * Lp + i) : 0.0f;
    }
    float lmax = 0.0f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int k = tid + r * nt;
      const int i = base + k;
      const int j = d - i;
      float M = 0.0f, X = 0.0f, Y = 0.0f;
      if (j >= 0 && j < R && i < L) {
        // raw M, X, Y of d-1 at lane i-1
        const float4 n4 = nb[k];
        const float nm = n4.x, nx = n4.y, ny = n4.z;
        const float om = Mr[r], ox = Xr[r], oy = Yr[r];
        const float qm = pm[r], qx = px[r], qy = py[r];
        pm[r] = nm; px[r] = nx; py[r] = ny;
        if (i > 0) {
          const float a = ext * (nx * inv1);
          const float c = gcgo * (ny * inv1);
          const float e = nggo * (nm * inv1);
          X = (a + c) + e;
        }
        if (j > 0) {
          const float a = ext * (oy * inv1);
          const float c = gcgo * (ox * inv1);
          const float e = nggo * (om * inv1);
          Y = (a + c) + e;
        }
        if (i > 0 && j > 0) {
          const float m2 = (qm * inv2) * inv1;
          const float x2 = (qx * inv2) * inv1;
          const float y2 = (qy * inv2) * inv1;
          const float a = ng2 * m2;
          const float c = gcng * x2;
          const float e = gcng * y2;
          M = ms[r] * ((a + c) + e);
        }
      }
      if (i < Lp) {
        const float4 v = make_float4(M, X, Y, 0.0f);
        wb[k + 1] = v;
        // the CTA's last lane is the next CTA's lane -1
        if (CL && k == LC - 1 && next != nullptr) next[(d & 1) * LS] = v;
      }
      Mr[r] = M; Xr[r] = X; Yr[r] = Y;
      lmax = fmaxf(lmax, fmaxf(fmaxf(M, X), Y));
    }
    if constexpr (CL) {
      cta_max_to_cluster(lmax, wloc, wrem + WS * (d & 1), rank, C);
      cluster_arrive();
      if constexpr (DEFER) store(d - 1);   // no peer reads the planes
      cluster_wait();
    } else {
      warp_max(lmax, wmax + WS * (d & 1));
      __syncthreads();
    }
  }
  // diagonal D-1; the barrier of step D-1 was the last: no peer stores
  // into this CTA after it, so it may exit
  scale(D - 1);
  store(D - 1);
}

// ---------------------------------------------------------------- fan-in
struct FaninArgs {
  const float* msp;     // (B, D, Lp)
  const int* loff;      // (B, Lp, KL) backward-edge offsets (0: none)
  const float* lw;      // (B, Lp, KL)
  const int* roff;      // (B, Rr, KR)
  const float* rw;      // (B, Rr, KR)
  const float* consts;  // (B, 8)
  const int* iscal;     // (B, 2)
  float* planes;        // (B, 3, D, Lp)
  float* cum;           // (B, D)
  float4* gring;        // (B, G + 1, Lp) of (M, X, Y, 0) when H < G + 1
  int D, Lp, Rr, KL, KR, G;
  int H;                // diagonals kept in shared memory (G + 1: all)
  int rtab;             // 1: the right-slot table copied to shared memory
};

// KLT, KRT: the fan-in, or 0 for runtime K. ROWS: lanes a thread, raw
// values of d-1 in registers (0: any count, read back from the ring slot
// of d-1). ALLSH: the whole ring in shared memory (H == G + 1). MAXT: the
// largest block it is launched with (sets the register budget).
template <int KLT, int KRT, int ROWS, bool ALLSH, int MAXT>
__global__ void __launch_bounds__(MAXT) fullprob_fwd_fanin_kernel(
    FaninArgs a) {
  constexpr int NL = KLT > 0 ? KLT : 1;
  constexpr int RR = ROWS > 0 ? ROWS : 1;
  extern __shared__ float4 sh4[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nw = (nt + 31) >> 5;
  const int D = a.D, Lp = a.Lp, G = a.G, GR = a.G + 1, H = a.H;
  const int KL = KLT > 0 ? KLT : a.KL;
  const int KR = KRT > 0 ? KRT : a.KR;
  const int nrows = ROWS > 0 ? ROWS : (Lp + nt - 1) / nt;
  // shared: warp maxima [2][32], hot ring [H][Lp] of (M, X, Y, 0), 1/s
  // ring [G+1], then (rtab) the right-site slot offsets and weights
  // [Rr][KR]
  float* wmax = reinterpret_cast<float*>(sh4);
  float4* hot = sh4 + 16;
  const size_t HS = (size_t)H * Lp;
  float* invh = reinterpret_cast<float*>(hot + HS);
  float4* gr = ALLSH ? nullptr : a.gring + (size_t)b * GR * Lp;
  const float ext = a.consts[b * 8 + 0];
  const float gcgo = a.consts[b * 8 + 1];
  const float nggo = a.consts[b * 8 + 2];
  const float ng2 = a.consts[b * 8 + 3];
  const float gcng = a.consts[b * 8 + 4];
  const int L = a.iscal[b * 2 + 0];
  const int R = a.iscal[b * 2 + 1];
  const float* mb = a.msp + (size_t)b * D * Lp;
  const int* lo_g = a.loff + (size_t)b * Lp * KL;
  const float* lw_g = a.lw + (size_t)b * Lp * KL;
  const int* ro_g = a.roff + (size_t)b * a.Rr * KR;
  const float* rw_g = a.rw + (size_t)b * a.Rr * KR;
  int* rso_s = reinterpret_cast<int*>(invh + GR);
  float* rsw_s = reinterpret_cast<float*>(rso_s + (size_t)a.Rr * KR);
  const int* rso = a.rtab ? rso_s : ro_g;
  const float* rsw = a.rtab ? rsw_s : rw_g;
  float* pM = a.planes + ((size_t)b * 3 + 0) * D * Lp;
  float* pX = a.planes + ((size_t)b * 3 + 1) * D * Lp;
  float* pY = a.planes + ((size_t)b * 3 + 2) * D * Lp;
  float* cb = a.cum + (size_t)b * D;

  // slot 0 holds diagonal 0: raw M(0, 0) = 1, all else 0
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 one4 = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
  for (size_t q = tid; q < HS; q += nt) hot[q] = q == 0 ? one4 : zero4;
  if constexpr (!ALLSH)
    for (size_t q = tid; q < (size_t)GR * Lp; q += nt)
      gr[q] = q == 0 ? one4 : zero4;
  for (int g = tid; g < GR; g += nt) invh[g] = 1.0f;
  if (a.rtab) {
    for (int q = tid; q < a.Rr * KR; q += nt) {
      rso_s[q] = __ldg(ro_g + q);
      rsw_s[q] = __ldg(rw_g + q);
    }
  }

  // a left slot with no edge, past G or past lane 0 holds 0
  auto left_off = [&](int i, int k) -> int {
    const int o = __ldg(lo_g + (size_t)i * KL + k);
    return (o > 0 && o <= G && o <= i) ? o : 0;
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
  // raw M, X, Y of diagonal d-1 (ROWS > 0); msp of d, loaded a step early
  float Mr[RR], Xr[RR], Yr[RR], msn[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int i = tid + r * nt;
    Mr[r] = Xr[r] = Yr[r] = 0.0f;
    msn[r] = ROWS > 0 && i < Lp ? __ldg(mb + Lp + i) : 0.0f;
  }
  if (ROWS > 0 && tid == 0) Mr[0] = 1.0f;

  float cumv = 0.0f;
  float inv1 = 1.0f, inv2 = 1.0f;  // 1/s of diagonals d-1, d-2
  int sg = 1;                      // slot of d, global ring and invh
  int shs = H > 1 ? 1 : 0;         // slot of d, hot ring
  warp_max(tid == 0 ? 1.0f : 0.0f, wmax);
  __syncthreads();

  // the finish of diagonal e (global slot g1, hot slot h1): s from
  // warp-maxima row e & 1, its lanes scaled, planes, cum, 1/s
  auto finish = [&](int e, int g1, int h1) {
    float s = row_max(wmax + 32 * (e & 1), nw);
    if (!(s > 0.0f)) s = 1.0f;
    const float inv = 1.0f / s;
    inv2 = inv1;
    inv1 = inv;
    cumv = cumv + logf(s);
    // ROWS == 0: raw values wait in the slot of e, on chip where it is
    const float4* raw = H > 0 ? hot + (size_t)h1 * Lp : gr + (size_t)g1 * Lp;
#pragma unroll
    for (int r = 0; r < (ROWS > 0 ? ROWS : nrows); ++r) {
      const int i = tid + r * nt;
      if (i >= Lp) continue;
      float M, X, Y;
      if constexpr (ROWS > 0) {
        M = Mr[r]; X = Xr[r]; Y = Yr[r];
      } else {
        const float4 v = raw[i];
        M = v.x; X = v.y; Y = v.z;
      }
      __stcs(pM + (size_t)e * Lp + i, M * inv);
      __stcs(pX + (size_t)e * Lp + i, X * inv);
      __stcs(pY + (size_t)e * Lp + i, Y * inv);
    }
    if (tid == 0) {
      cb[e] = cumv;
      invh[g1] = inv;
    }
  };

  for (int d = 1; d < D; ++d) {
    const int g1 = sg == 0 ? GR - 1 : sg - 1;
    const int h1 = shs == 0 ? (H > 0 ? H - 1 : 0) : shs - 1;
    finish(d - 1, g1, h1);

    // raw (M, X, Y) of diagonal d-o at `lane` (1 <= o <= G)
    auto rd = [&](int o, int lane) -> float4 {
      int hs = shs - o;
      hs += hs < 0 ? H : 0;
      if constexpr (ALLSH) {
        return hot[(size_t)hs * Lp + lane];
      } else {
        if (o < H) return hot[(size_t)hs * Lp + lane];
        int gs = sg - o;
        gs += gs < 0 ? GR : 0;
        return gr[(size_t)gs * Lp + lane];
      }
    };
    // the values of v times 1/s of diagonals d-n, d-n+1, ..., d-1, in
    // that order
    auto scale = [&](float4 v, int n) -> float4 {
      if (n >= 3) {
        int s = sg - n;
        s += s < 0 ? GR : 0;
        for (int t = n; t >= 3; --t) {
          const float f = invh[s];
          v.x = v.x * f; v.y = v.y * f; v.z = v.z * f;
          s = s + 1 == GR ? 0 : s + 1;
        }
      }
      if (n >= 2) {
        v.x = v.x * inv2; v.y = v.y * inv2; v.z = v.z * inv2;
      }
      v.x = v.x * inv1; v.y = v.y * inv1; v.z = v.z * inv1;
      return v;
    };
    // the three sources' combinations of (M, X, Y) in the units of d-1
    auto xterm = [&](float4 v) -> float {
      return ((ext * v.y) + (gcgo * v.z)) + (nggo * v.x);
    };
    auto yterm = [&](float4 v) -> float {
      return ((ext * v.z) + (gcgo * v.y)) + (nggo * v.x);
    };
    auto mterm = [&](float4 v) -> float {
      return ((ng2 * v.x) + (gcng * v.y)) + (gcng * v.z);
    };

    float ms[RR];
    if constexpr (ROWS > 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = tid + r * nt;
        ms[r] = msn[r];
        msn[r] = i < Lp && d + 1 < D
                     ? __ldg(mb + (size_t)(d + 1) * Lp + i) : 0.0f;
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
        // without a branch; a source that does not exist reads diagonal
        // d-1 at lane i and contributes 0
        const int ol0 = lof(0), or0 = rof(0);
        const bool okA = ol0 > 0;
        const bool okB = j > 0 && or0 > 0 && or0 <= G;
        const bool okT = okA && okB && ol0 + or0 <= G;
        const int oa = okA ? ol0 : 1, ob = okB ? or0 : 1;
        const int ot = okT ? ol0 + or0 : 1;
        const float4 va = rd(oa, okA ? i - ol0 : i);
        const float4 vb = rd(ob, i);
        const float4 vt = rd(ot, okT ? i - ol0 : i);
        float A = 0.0f, Bs = 0.0f, T = 0.0f;
        A = A + (okA ? xterm(scale(va, oa)) : 0.0f);
#pragma unroll
        for (int k = 1; k < KL; ++k) {
          const int o = lof(k);
          if (o > 0) A = A + xterm(scale(rd(o, i - o), o));
        }
        if (j > 0) {
          Bs = Bs + (okB ? yterm(scale(vb, ob)) : 0.0f);
#pragma unroll
          for (int k = 1; k < KR; ++k) {
            const int o = rof(k);
            if (o > 0 && o <= G) Bs = Bs + yterm(scale(rd(o, i), o));
          }
          if (okT) T = T + (mterm(scale(vt, ot)) * lwf(0)) * rwf(0);
#pragma unroll
          for (int kl = 0; kl < KL; ++kl) {
            const int ol = lof(kl);
            if (ol <= 0) continue;
            const float wl = lwf(kl);
#pragma unroll
            for (int kr = kl == 0 ? 1 : 0; kr < KR; ++kr) {
              const int orr = rof(kr);
              const int os = ol + orr;
              if (!(orr > 0 && os <= G)) continue;
              T = T + (mterm(scale(rd(os, i - ol), os)) * wl) * rwf(kr);
            }
          }
        }
        X = A;
        Y = Bs;
        if (i > 0 && j > 0) {
          float msd;
          if constexpr (ROWS > 0) msd = ms[r];
          else msd = __ldg(mb + (size_t)d * Lp + i);
          M = msd * T;
        }
      }
      if (i < Lp) {
        const float4 v = make_float4(M, X, Y, 0.0f);
        if (H > 0) hot[(size_t)shs * Lp + i] = v;
        if constexpr (!ALLSH) gr[(size_t)sg * Lp + i] = v;
      }
      if constexpr (ROWS > 0) {
        Mr[r] = M; Xr[r] = X; Yr[r] = Y;
      }
      lmax = fmaxf(lmax, fmaxf(fmaxf(M, X), Y));
    }
    warp_max(lmax, wmax + 32 * (d & 1));
    __syncthreads();
    sg = sg + 1 == GR ? 0 : sg + 1;
    if (H > 0) shs = shs + 1 == H ? 0 : shs + 1;
  }
  // diagonal D-1: its slots are the ones before the slot counters
  finish(D - 1, sg == 0 ? GR - 1 : sg - 1,
         shs == 0 ? (H > 0 ? H - 1 : 0) : shs - 1);
}

// the fan-in kernel, as fullprob_common.cuh's dispatch takes it
struct FaninBuilds {
  using Args = FaninArgs;
  template <int KLT, int KRT, int ROWS, bool ALLSH, int MAXT>
  static auto kernel() {
    return fullprob_fwd_fanin_kernel<KLT, KRT, ROWS, ALLSH, MAXT>;
  }
};

}  // namespace

// The linear plan, as fullprob_fill.py::fwd_linear_plan computes it:
// rows: lanes a thread; cluster: 0 for a lane build (one block a job,
// rows 1 or 2, rows x threads >= Lp), else the CTAs of the job's
// cluster (2 to 16, rows 2 or 4, cluster x rows x threads >= Lp);
// smem: the rows of two diagonals, 16 bytes a lane of the block or CTA
// and one more.
extern "C" int fullprob_fwd_linear_launch(
    const void* ms2, const void* consts, const void* iscal, void* planes,
    void* cum, int B, int D, int Lp, int rows, int cluster, int threads,
    int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long lanes = (long)rows * threads * (cluster ? cluster : 1);
  if (threads < 32 || threads > 1024 || threads % 32 || lanes < Lp ||
      D < 2 || B < 1 ||
      (size_t)smem < (size_t)2 * ((cluster ? rows * threads : Lp) + 1) *
                         sizeof(float4))
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
        return launch_cluster(fullprob_fwd_linear_kernel<2, true>, cluster,
                              B, threads, (size_t)smem, st, m, c, is, p, cu,
                              D, Lp);
      case 4:
        return launch_cluster(fullprob_fwd_linear_kernel<4, true>, cluster,
                              B, threads, (size_t)smem, st, m, c, is, p, cu,
                              D, Lp);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (rows) {
#define FWD_LIN(n)                                                          \
  case n:                                                                   \
    err = allow_smem(fullprob_fwd_linear_kernel<n, false>, (size_t)smem);   \
    if (err != cudaSuccess) return (int)err;                                \
    fullprob_fwd_linear_kernel<n, false><<<B, threads, smem, st>>>(         \
        m, c, is, p, cu, D, Lp);                                            \
    return (int)cudaGetLastError();
    FWD_LIN(1)
    FWD_LIN(2)
#undef FWD_LIN
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of the cluster build (rows 2 or 4) of `cluster`
// CTAs of `threads` threads and smem bytes the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the error of the query.
extern "C" int fullprob_fwd_linear_clusters(int rows, int cluster,
                                            int threads, int smem) {
  if (rows == 2)
    return cluster_fit(fullprob_fwd_linear_kernel<2, true>, cluster,
                       threads, (size_t)smem);
  if (rows == 4)
    return cluster_fit(fullprob_fwd_linear_kernel<4, true>, cluster,
                       threads, (size_t)smem);
  return -(int)cudaErrorInvalidValue;
}

// The fan-in plan, as fullprob_fill.py::fwd_fanin_plan computes it:
// hot: diagonals kept in shared memory (G + 1: the whole ring; fewer:
// all of them also in gring; 0: gring only); klt, krt: the templated
// fan-in (0, 0: runtime K); rows: lanes a thread (2, or 4 up to a
// templated K 2 x 2; 0: any count, runtime K only); threads: the
// block; smem: dynamic shared bytes (warp maxima, hot ring of 16 bytes
// a lane, 1/s ring and, with rtab, the right-slot table); rtab: 1 copies
// the table to shared memory, 0 reads it from device memory.
extern "C" int fullprob_fwd_fanin_launch(
    const void* msp, const void* loff, const void* lw, const void* roff,
    const void* rw, const void* consts, const void* iscal, void* planes,
    void* cum, void* gring, int B, int D, int Lp, int Rr, int KL, int KR,
    int G, int hot, int rtab, int klt, int krt, int rows, int threads,
    int smem, void* stream) {
  FaninArgs a;
  a.msp = (const float*)msp;
  a.loff = (const int*)loff;
  a.lw = (const float*)lw;
  a.roff = (const int*)roff;
  a.rw = (const float*)rw;
  a.consts = (const float*)consts;
  a.iscal = (const int*)iscal;
  a.planes = (float*)planes;
  a.cum = (float*)cum;
  a.gring = (float4*)gring;
  a.D = D;
  a.Lp = Lp;
  a.Rr = Rr;
  a.KL = KL;
  a.KR = KR;
  a.G = G;
  a.H = hot;
  a.rtab = rtab != 0;
  if (G < 1 || D < 2 || hot < 0 || hot > G + 1 ||
      (hot <= G && gring == nullptr) || threads < 32 || threads % 32 ||
      (rows > 0 && (long)rows * threads < Lp) ||
      (size_t)smem < ((size_t)64 + G + 1 + (size_t)4 * hot * Lp +
                      (a.rtab ? (size_t)2 * Rr * KR : 0)) * 4)
    return (int)cudaErrorInvalidValue;
  return dispatch<FaninBuilds>(a, klt, krt, B, rows, threads,
                               (size_t)smem, (cudaStream_t)stream);
}
