// Kernels G and H: one block of diagonals of one shard of a band-sharded
// Viterbi fill (align/viterbi_shardband.py), linear (G) and fan-in (H).
//
// They replace no Pallas kernel: the JAX package runs these fills as
// shard_map scans of XLA code (pagan2_tpu/align/viterbi_shardband.py,
// _build_fill :83 and _build_fanin_fill :362). A plain PyTorch loop on
// the card would issue tens of operations a diagonal, and a pair at the
// sharding gate (65,536 left sites) has 70k-130k diagonals, so each
// block of diagonals is one launch here.
//
// The lane axis (the left sequence's rows) is split over the shards:
// shard k owns local lanes [H, H + w) = global rows [k*w, (k+1)*w), and
// its carry holds an H-lane halo [0, H) of its left neighbour's rows as
// they stood when the block began. A linear step reads one lane to the
// left, a fan-in step up to OLm lanes, so after t steps the first t
// (t * OLm) lanes of a shard are stale and the owned lanes exact as long
// as a launch runs at most H (H / OLm) steps. The host then copies each
// shard's last H owned lanes into the next shard's halo.
//
// Inside a launch the same idea tiles the shard: CUDA block b runs tile
// t_lo + b, which loads local lanes [t*TT, t*TT + H + TT) from the carry
// (TT = the block's lanes - H) and owns the last TT of them, so no block
// waits for another and a diagonal costs one __syncthreads. The host's
// launch plan (linear_launch_plan, fanin_launch_plan) launches only the
// tiles whose lanes hold a cell of the block or a carry that can be
// finite; the codes start filled with the masked code, and a kernel
// writes the code of a cell only where it lies in the matrix and band.
//
// Recurrences and codes are the reference's scan cores, bit for bit:
//  G (batched_sheared_core): X from (i-1, j): ext x + gj[j], double
//    y + lgo, open (m + lng) + olp[i]; Y from (i, j-1): ext y + gexti[i],
//    double x + lgo, open (m + lng) + orp[j]; M from (i-1, j-1):
//    (m + lng) + wadd, x + wadd, y + wadd with
//    wadd = ((lng + ms) + lw[i]) + rw[j] (folded on the host, compared
//    after the add); first wins on a tie; codes bm | bx << 2 | by << 4,
//    3 where masked.
//  H (_build_core_onehot): per left edge slot kk (offset o) X's ext,
//    double, open; per right slot Y's; per (kl, kr) pair M's m, x, y;
//    strict-greater first-wins over the reference's order; codes
//    bm | bx << 16 | by << 24 with 65535 / 255 / 255 where masked.
// Only additions, maxima and selects: no multiply, so nvcc contracts
// nothing and the f32 results equal the plain versions'.
//
// What bounds them on an H100: neither bytes nor operations (a cell
// reads its match score and writes one code) but the chain of dependent
// diagonals, one barrier each, and the host's launch of each block with
// the halo exchange between launches. The design, after kernel A's
// (G, csrc/viterbi_linear.cu) and kernel B's (H, csrc/viterbi_fanin.cu):
//  G1. A thread owns ROWS = 2 consecutive lanes; their M, X, Y of
//      diagonal d-1 stay in registers. Lane i-1 of a thread's first lane
//      is the last lane of the thread below, by __shfl_up_sync, or of the
//      warp below, from a shared row of warp-edge values taken in turn by
//      the parity of d: one __syncthreads a diagonal. A diagonal takes
//      longer the more warps a block holds (0.50 us at 256 threads, 1.08
//      at 1,024; four rows a thread were slower at every width tried),
//      while the few tiles of a launch run side by side on their own SMs:
//      the plan's default block is 256 threads (512 lanes, half of them
//      halo at H = 256).
//  G2. M at (i, j) reads diagonal d-2 at lane i-1, which X read at step
//      d-1: step d-1 keeps M's three candidates for step d, and no value
//      of d-2 is read again (only kept for the carry).
//  G3. The folded match scores arrive sheared by the host, entry
//      [d - base][j] for cell (d - j, j): the lanes of a warp read
//      consecutive columns of one row, one coalesced load a lane and
//      diagonal, fetched (with gj[j] and orp[j]) a diagonal ahead.
//  G4. A warp skips a diagonal on which none of its lanes holds a cell
//      and none holds one on the next (its M candidates are needed
//      there): it sets its values to -inf without computing, as the
//      plain version's masks would.
//  H1. One lane a thread, the ring of the last G + 1 diagonals of M, X,
//      Y in shared memory for the whole launch (up to 1,024 lanes; 256 by
//      the plan, for the reason of G1: 1.27 us a diagonal against 2.38 at
//      1,024), its slots advanced by a counter (no division).
//  H2. Templated fan-in (KL, KR in 1..4; 0: any K through the L1): the
//      lane's edge words stay in registers, the candidate loops unroll.
//  H3. The column inputs of the next diagonal (rstate, gextj and the
//      right edge words) and the match score from the nf x nf table are
//      loaded before the barrier of the diagonal before.
//  H4. A warp skips a diagonal on which none of its lanes holds a cell.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int FAR = 0x3fffffff;

// ------------------------------------------------------------------
// kernel G: ROWS consecutive lanes a thread
constexpr int ROWS = 2;

__global__ void __launch_bounds__(1024) shardband_linear_kernel(
    const float* __restrict__ cin, float* __restrict__ cout,
    uint8_t* __restrict__ codes, float* __restrict__ corner,
    const float* __restrict__ ms, const float* __restrict__ gexti,
    const float* __restrict__ olp, const int* __restrict__ vlo,
    const int* __restrict__ vhi, const float* __restrict__ gj,
    const float* __restrict__ orp, float lng, float lgo, int L, int R,
    int base, int H, int d0, int nsteps, int wloc, int t_lo) {
  // last lane's M, X, Y of each warp, by the parity of its diagonal
  __shared__ float4 edge[2][32];
  const float NEG = -INFINITY;
  const int nt = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int lane0 = (t_lo + blockIdx.x) * (nt * ROWS - H);
  const int w = wloc - H;
  const int last = L + R - 2;

  int li[ROWS], ii[ROWS], dlo[ROWS], dhi[ROWS];
  bool owned[ROWS];
  float gx[ROWS], ol[ROWS];
  float M1[ROWS], X1[ROWS], Y1[ROWS], M2[ROWS], X2[ROWS], Y2[ROWS];
  int tlo = FAR, thi = -FAR;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int tl = tid * ROWS + k;
    li[k] = lane0 + tl;
    ii[k] = base + li[k];
    const bool live = li[k] < wloc;
    owned[k] = live && tl >= H;
    gx[k] = ol[k] = 0.f;
    dlo[k] = FAR;
    dhi[k] = -FAR;
    M1[k] = X1[k] = Y1[k] = M2[k] = X2[k] = Y2[k] = NEG;
    if (live) {
      const int l = li[k];
      gx[k] = gexti[l];
      ol[k] = olp[l];
      M1[k] = cin[l];
      X1[k] = cin[wloc + l];
      Y1[k] = cin[2 * wloc + l];
      M2[k] = cin[3 * wloc + l];
      X2[k] = cin[4 * wloc + l];
      Y2[k] = cin[5 * wloc + l];
      // the diagonals on which the lane holds a cell in matrix and band
      const int lo = max(vlo[l], 0), hi = min(vhi[l], R - 1);
      if (ii[k] < L && lo <= hi) {
        dlo[k] = ii[k] + lo;
        dhi[k] = ii[k] + hi;
      }
    }
    tlo = min(tlo, dlo[k]);
    thi = max(thi, dhi[k]);
  }
  // the warp computes diagonal d when a lane holds a cell on d or d + 1
  const int wlo = __reduce_min_sync(FULL, tlo) - 1;
  const int whi = __reduce_max_sync(FULL, thi);

  // M's candidates for step d0: lane i-1 on diagonal d0 - 2 (-inf left
  // of the tile's first lane)
  float mcn[ROWS], mcx[ROWS], mcy[ROWS];
  {
    const int l = li[0] - 1;
    const bool ok = tid > 0 && l < wloc;
    mcn[0] = ok ? cin[3 * wloc + l] + lng : NEG;
    mcx[0] = ok ? cin[4 * wloc + l] : NEG;
    mcy[0] = ok ? cin[5 * wloc + l] : NEG;
  }
#pragma unroll
  for (int k = 1; k < ROWS; ++k) {
    mcn[k] = M2[k - 1] + lng;
    mcx[k] = X2[k - 1];
    mcy[k] = Y2[k - 1];
  }

  // the folded score and the column words of diagonal e, a step ahead
  float wq[ROWS], gq[ROWS], oq[ROWS];
  auto fetch = [&](int e) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      wq[k] = gq[k] = oq[k] = 0.f;
      if (e >= dlo[k] && e <= dhi[k]) {
        const int j = e - ii[k];
        wq[k] = __ldg(ms + (size_t)(e - base) * R + j);
        gq[k] = __ldg(gj + j);
        oq[k] = __ldg(orp + j);
      }
    }
  };
  fetch(d0);
  if (lane == 31)
    edge[(d0 - 1) & 1][wp] =
        make_float4(M1[ROWS - 1], X1[ROWS - 1], Y1[ROWS - 1], 0.f);
  __syncthreads();

  for (int t = 0; t < nsteps; ++t) {
    const int d = d0 + t;
    float wc[ROWS], gc[ROWS], oc[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      wc[k] = wq[k];
      gc[k] = gq[k];
      oc[k] = oq[k];
    }
    if (t + 1 < nsteps) fetch(d + 1);
    if (d >= wlo && d <= whi) {
      // lane i-1 on diagonal d-1: the thread below, or the warp below
      float pm = __shfl_up_sync(FULL, M1[ROWS - 1], 1);
      float px = __shfl_up_sync(FULL, X1[ROWS - 1], 1);
      float py = __shfl_up_sync(FULL, Y1[ROWS - 1], 1);
      if (lane == 0) {
        const float4 e = wp > 0 ? edge[(d - 1) & 1][wp - 1]
                                : make_float4(NEG, NEG, NEG, 0.f);
        pm = e.x;
        px = e.y;
        py = e.z;
      }
      float Mn[ROWS], Xn[ROWS], Yn[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const float m1p = k == 0 ? pm : M1[k - 1];
        const float x1p = k == 0 ? px : X1[k - 1];
        const float y1p = k == 0 ? py : Y1[k - 1];
        const int j = d - ii[k];
        const bool valid = d >= dlo[k] && d <= dhi[k];
        // X: gap consuming left site i (ext, double, open)
        const float t1 = m1p + lng;
        const float cx0 = x1p + gc[k], cx1 = y1p + lgo, cx2 = t1 + ol[k];
        float vx = cx0;
        int bx = 0;
        if (cx1 > vx) { vx = cx1; bx = 1; }
        if (cx2 > vx) { vx = cx2; bx = 2; }
        const bool okx = valid && ii[k] > 0 && isfinite(vx);
        // Y: gap consuming right site j (ext, double, open)
        const float cy0 = Y1[k] + gx[k], cy1 = X1[k] + lgo,
                    cy2 = (M1[k] + lng) + oc[k];
        float vy = cy0;
        int by = 0;
        if (cy1 > vy) { vy = cy1; by = 1; }
        if (cy2 > vy) { vy = cy2; by = 2; }
        const bool oky = valid && j > 0 && isfinite(vy);
        // M: the candidates kept at step d-1, compared after the add
        const float a0 = mcn[k] + wc[k], a1 = mcx[k] + wc[k],
                    a2 = mcy[k] + wc[k];
        float vm = a0;
        int bm = 0;
        if (a1 > vm) { vm = a1; bm = 1; }
        if (a2 > vm) { vm = a2; bm = 2; }
        const bool okm = valid && ii[k] > 0 && j > 0 && isfinite(vm);
        Mn[k] = okm ? vm : NEG;
        Xn[k] = okx ? vx : NEG;
        Yn[k] = oky ? vy : NEG;
        // M's candidates at (i, j+1) on diagonal d+1
        mcn[k] = t1;
        mcx[k] = x1p;
        mcy[k] = y1p;
        if (valid && owned[k]) {
          codes[(size_t)d * w + (li[k] - H)] = (uint8_t)(
              (okm ? bm : 3) | ((okx ? bx : 3) << 2) | ((oky ? by : 3) << 4));
          if (d == last && ii[k] == L - 1) {
            corner[0] = Mn[k];
            corner[1] = Xn[k];
            corner[2] = Yn[k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        M2[k] = M1[k];
        X2[k] = X1[k];
        Y2[k] = Y1[k];
        M1[k] = Mn[k];
        X1[k] = Xn[k];
        Y1[k] = Yn[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        M2[k] = M1[k];
        X2[k] = X1[k];
        Y2[k] = Y1[k];
        M1[k] = X1[k] = Y1[k] = mcn[k] = mcx[k] = mcy[k] = NEG;
      }
    }
    if (lane == 31)
      edge[d & 1][wp] =
          make_float4(M1[ROWS - 1], X1[ROWS - 1], Y1[ROWS - 1], 0.f);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    if (owned[k]) {
      const int l = li[k];
      cout[l] = M1[k];
      cout[wloc + l] = X1[k];
      cout[2 * wloc + l] = Y1[k];
      cout[3 * wloc + l] = M2[k];
      cout[4 * wloc + l] = X2[k];
      cout[5 * wloc + l] = Y2[k];
    }
  }
}

// ------------------------------------------------------------------
// kernel H
struct FaninArgs {
  const float* cin;
  float* cout;
  int32_t* codes;
  float* snap;
  const int* lstate;
  const float* table;
  const int* loff;
  const float* llw;
  const float* lopen;
  const float* gexti;
  const int* vlo;
  const int* vhi;
  const int* rstate;
  const float* gextj;
  const int* roff;
  const float* rlw;
  const float* ropen;
  float lng, lgo;
  int L, R, base, H, d0, nsteps, wloc, G, KL, KR, nf, t_lo;
};

template <int KLT, int KRT>
__global__ void __launch_bounds__(1024) shardband_fanin_kernel(FaninArgs a) {
  extern __shared__ float ring[];      // [M, X, Y][G + 1 slots][nt]
  constexpr int NL = KLT > 0 ? KLT : 1;
  constexpr int NR = KRT > 0 ? KRT : 1;
  const float NEG = -INFINITY;
  const int nt = blockDim.x;
  const int G = a.G, GR = a.G + 1;
  const int KL = KLT > 0 ? KLT : a.KL;
  const int KR = KRT > 0 ? KRT : a.KR;
  const int tid = threadIdx.x;
  const int li = (a.t_lo + blockIdx.x) * (nt - a.H) + tid;
  const int w = a.wloc - a.H;
  const bool live = li < a.wloc;
  const bool owned = live && tid >= a.H;
  const int ii = a.base + li;
  const int R = a.R, nf = a.nf;
  const float lng = a.lng, lgo = a.lgo;
#define RING(m, s, lane) ring[((m) * GR + (s)) * nt + (lane)]

  // diagonal d0 + t sits in slot t mod GR; d0 - 1 - g in GR - 1 - g
  for (int g = 0; g < G; ++g)
    for (int m = 0; m < 3; ++m)
      RING(m, GR - 1 - g, tid) =
          live ? a.cin[((size_t)m * G + g) * a.wloc + li] : NEG;
  float gi = 0.f;
  int ls = 0, dlo = FAR, dhi = -FAR;
  int lo_[NL];
  float lw_[NL], lop_[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    lo_[k] = 0;
    lw_[k] = lop_[k] = 0.f;
  }
  const int lrow = live ? li : 0;
  if (live) {
    gi = a.gexti[li];
    ls = a.lstate[li];
    const int lo = max(a.vlo[li], 0), hi = min(a.vhi[li], R - 1);
    if (ii >= 0 && ii < a.L && lo <= hi) {
      dlo = ii + lo;
      dhi = ii + hi;
    }
    if constexpr (KLT > 0) {
#pragma unroll
      for (int k = 0; k < KLT; ++k) {
        lo_[k] = a.loff[(size_t)li * KLT + k];
        lw_[k] = a.llw[(size_t)li * KLT + k];
        lop_[k] = a.lopen[(size_t)li * KLT + k];
      }
    }
  }
  // row 0 seeds M(0, 0) = 0 on diagonal 0
  const bool seed = live && ii == 0;
  const int wlo = __reduce_min_sync(FULL, seed ? min(dlo, 0) : dlo);
  const int whi = __reduce_max_sync(FULL, seed ? max(dhi, 0) : dhi);

  // the column inputs of diagonal e and its match score, a step ahead
  int rsq = nf - 1, roq[NR];
  float gjq = 0.f, msq = 0.f, rlq[NR], ropq[NR];
  auto fetch = [&](int e) {
    const int jc = e - ii;
    const bool in = e >= dlo && e <= dhi;
    rsq = in ? __ldg(a.rstate + jc) : nf - 1;
    gjq = in ? __ldg(a.gextj + jc) : 0.f;
    if constexpr (KRT > 0) {
#pragma unroll
      for (int k = 0; k < KRT; ++k) {
        roq[k] = in ? __ldg(a.roff + (size_t)jc * KRT + k) : 0;
        rlq[k] = in ? __ldg(a.rlw + (size_t)jc * KRT + k) : 0.f;
        ropq[k] = in ? __ldg(a.ropen + (size_t)jc * KRT + k) : 0.f;
      }
    }
    msq = __ldg(a.table + ls * nf + rsq);
  };
  fetch(a.d0);
  __syncthreads();

  const int last = a.L + R - 2;
  int sc = 0;                           // the slot of diagonal d
  for (int t = 0; t < a.nsteps; ++t) {
    const int d = a.d0 + t;
    const int jj = d - ii;
    const float msv = msq, gjx = gjq;
    int ro[NR];
    float rl[NR], rop[NR];
    if constexpr (KRT > 0) {
#pragma unroll
      for (int k = 0; k < KRT; ++k) {
        ro[k] = roq[k];
        rl[k] = rlq[k];
        rop[k] = ropq[k];
      }
    }
    if (t + 1 < a.nsteps) fetch(d + 1);
    float M = NEG, X = NEG, Y = NEG;
    if (d >= wlo && d <= whi) {
      const bool valid = d >= dlo && d <= dhi;
      const bool inr = jj >= 0 && jj < R;
      const int jc = inr ? jj : 0;
      auto slot = [&](int o) {
        const int s = sc - o;
        return s < 0 ? s + GR : s;
      };
      // the edge words of left slot k and of right slot k
      auto left = [&](int k, int& o, float& lw, float& op) {
        if constexpr (KLT > 0) {
          o = lo_[k];
          lw = lw_[k];
          op = lop_[k];
        } else {
          const size_t q = (size_t)lrow * KL + k;
          o = a.loff[q];
          lw = a.llw[q];
          op = a.lopen[q];
        }
      };
      auto right = [&](int k, int& o, float& lw, float& op) {
        if constexpr (KRT > 0) {
          o = ro[k];
          lw = rl[k];
          op = rop[k];
        } else {
          const size_t q = (size_t)jc * KR + k;
          o = valid ? a.roff[q] : 0;
          lw = valid ? a.rlw[q] : 0.f;
          op = valid ? a.ropen[q] : 0.f;
        }
      };
      float bestX = NEG, bestY = NEG, bestM = NEG;
      int codeX = 255, codeY = 255, codeM = 65535;
      const float mbase = lng + msv;
      // ---- X: gap consuming left site i, per left edge slot ----
#pragma unroll
      for (int kl = 0; kl < KL; ++kl) {
        int o;
        float lw, op;
        left(kl, o, lw, op);
        float vM = NEG, vX = NEG, vY = NEG;
        if (o >= 1 && o <= G && tid - o >= 0) {
          const int s = slot(o);
          vM = RING(0, s, tid - o);
          vX = RING(1, s, tid - o);
          vY = RING(2, s, tid - o);
        }
        float c = vX + gjx;
        if (c > bestX) { bestX = c; codeX = kl * 3; }
        c = vY + lgo;
        if (c > bestX) { bestX = c; codeX = kl * 3 + 1; }
        c = (vM + lng) + op;
        if (c > bestX) { bestX = c; codeX = kl * 3 + 2; }
      }
      // ---- Y: gap consuming right site j, per right edge slot ----
#pragma unroll
      for (int kr = 0; kr < KR; ++kr) {
        int o;
        float lw, op;
        right(kr, o, lw, op);
        float vM = NEG, vX = NEG, vY = NEG;
        if (o >= 1 && o <= G) {
          const int s = slot(o);
          vM = RING(0, s, tid);
          vX = RING(1, s, tid);
          vY = RING(2, s, tid);
        }
        float c = vY + gi;
        if (c > bestY) { bestY = c; codeY = kr * 3; }
        c = vX + lgo;
        if (c > bestY) { bestY = c; codeY = kr * 3 + 1; }
        c = (vM + lng) + op;
        if (c > bestY) { bestY = c; codeY = kr * 3 + 2; }
      }
      // ---- M: match consuming both, left slot outer, right inner ----
#pragma unroll
      for (int kl = 0; kl < KL; ++kl) {
        int s0;
        float lw, op;
        left(kl, s0, lw, op);
        const float lwb = mbase + lw;
#pragma unroll
        for (int kr = 0; kr < KR; ++kr) {
          int r;
          float rlk, rop_;
          right(kr, r, rlk, rop_);
          float vM = NEG, vX = NEG, vY = NEG;
          if (s0 >= 1 && r >= 1 && s0 + r <= G && tid - s0 >= 0) {
            const int s = slot(s0 + r);
            vM = RING(0, s, tid - s0);
            vX = RING(1, s, tid - s0);
            vY = RING(2, s, tid - s0);
          }
          const float b = lwb + rlk;
          const int c0 = (kl * KR + kr) * 3;
          float c = (vM + lng) + b;
          if (c > bestM) { bestM = c; codeM = c0; }
          c = vX + b;
          if (c > bestM) { bestM = c; codeM = c0 + 1; }
          c = vY + b;
          if (c > bestM) { bestM = c; codeM = c0 + 2; }
        }
      }
      const bool okx = valid && ii > 0 && isfinite(bestX);
      const bool oky = valid && jj > 0 && isfinite(bestY);
      const bool okm = valid && ii > 0 && jj > 0 && isfinite(bestM);
      M = okm ? bestM : NEG;
      if (ii == 0 && jj == 0) M = 0.f;
      X = okx ? bestX : NEG;
      Y = oky ? bestY : NEG;
      if (valid && owned)
        a.codes[(size_t)d * w + (li - a.H)] = (int32_t)(
            (uint32_t)(okm ? codeM : 65535) +
            ((uint32_t)(okx ? codeX : 255) << 16) +
            ((uint32_t)(oky ? codeY : 255) << 24));
    }
    RING(0, sc, tid) = M;
    RING(1, sc, tid) = X;
    RING(2, sc, tid) = Y;
    if (owned && d == last)
      for (int g = 0; g < G; ++g) {
        const int s = sc - g < 0 ? sc - g + GR : sc - g;
        for (int m = 0; m < 3; ++m)
          a.snap[((size_t)m * G + g) * w + (li - a.H)] = RING(m, s, tid);
      }
    sc = sc + 1 == GR ? 0 : sc + 1;
    __syncthreads();
  }
  if (owned) {
    // the last diagonal d0 + nsteps - 1 sits one slot before sc
    for (int g = 0; g < G; ++g) {
      int s = sc - 1 - g;
      if (s < 0) s += GR;
      for (int m = 0; m < 3; ++m)
        a.cout[((size_t)m * G + g) * a.wloc + li] = RING(m, s, tid);
    }
  }
#undef RING
}

typedef void (*FaninKernel)(FaninArgs);

template <int KL>
FaninKernel fanin_right(int KR) {
  switch (KR) {
    case 1: return shardband_fanin_kernel<KL, 1>;
    case 2: return shardband_fanin_kernel<KL, 2>;
    case 3: return shardband_fanin_kernel<KL, 3>;
    case 4: return shardband_fanin_kernel<KL, 4>;
  }
  return nullptr;
}

FaninKernel fanin_build(int KL, int KR) {
  if (KL >= 1 && KL <= 4 && KR >= 1 && KR <= 4) {
    switch (KL) {
      case 1: return fanin_right<1>(KR);
      case 2: return fanin_right<2>(KR);
      case 3: return fanin_right<3>(KR);
      case 4: return fanin_right<4>(KR);
    }
  }
  return shardband_fanin_kernel<0, 0>;
}

}  // namespace

extern "C" int shardband_linear_launch(
    const void* cin, void* cout, void* codes, void* corner, const void* ms,
    const void* gexti, const void* olp, const void* vlo, const void* vhi,
    const void* gj, const void* orp, float lng, float lgo, int L, int R,
    int base, int H, int d0, int nsteps, int wloc, int t_lo, int t_hi,
    int threads, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || H < 1 ||
      H >= threads * ROWS || nsteps < 1 || nsteps > H || t_lo < 0 ||
      t_hi < t_lo)
    return (int)cudaErrorInvalidValue;
  shardband_linear_kernel<<<t_hi - t_lo + 1, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)cin, (float*)cout, (uint8_t*)codes, (float*)corner,
      (const float*)ms, (const float*)gexti, (const float*)olp,
      (const int*)vlo, (const int*)vhi, (const float*)gj, (const float*)orp,
      lng, lgo, L, R, base, H, d0, nsteps, wloc, t_lo);
  return (int)cudaGetLastError();
}

extern "C" int shardband_fanin_launch(
    const void* cin, void* cout, void* codes, void* snap, const void* lstate,
    const void* table, const void* loff, const void* llw, const void* lopen,
    const void* gexti, const void* vlo, const void* vhi, const void* rstate,
    const void* gextj, const void* roff, const void* rlw, const void* ropen,
    float lng, float lgo, int L, int R, int base, int H, int d0, int nsteps,
    int wloc, int G, int KL, int KR, int nf, int t_lo, int t_hi,
    int threads, int smem, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || H < 1 ||
      H >= threads || G < 1 || KL < 1 || KR < 1 || t_lo < 0 ||
      t_hi < t_lo || smem != 12 * (G + 1) * threads)
    return (int)cudaErrorInvalidValue;
  const FaninKernel kern = fanin_build(KL, KR);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  FaninArgs a{(const float*)cin,   (float*)cout,         (int32_t*)codes,
              (float*)snap,        (const int*)lstate,   (const float*)table,
              (const int*)loff,    (const float*)llw,    (const float*)lopen,
              (const float*)gexti, (const int*)vlo,      (const int*)vhi,
              (const int*)rstate,  (const float*)gextj,  (const int*)roff,
              (const float*)rlw,   (const float*)ropen,  lng,
              lgo,                 L,                    R,
              base,                H,                    d0,
              nsteps,              wloc,                 G,
              KL,                  KR,                   nf,
              t_lo};
  kern<<<t_hi - t_lo + 1, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
