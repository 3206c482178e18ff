// Kernel B: graph-vs-graph (fan-in) 3-state Viterbi wavefront.
//
// Replaces the TPU kernel pagan2_tpu/align/viterbi_pallas_fanin.py::
// _kernel (launched by pallas_fanin_fill / pallas_fanin_run) and does
// the work of the XLA scan cores pagan2_tpu/align/viterbi_fanin.py::
// _build_core_onehot and ::_build_core, windowed or at full width. A
// site's bwd edges skip o >= 1 sites, so a gap move reads diagonal d-o
// and a match move diagonal d-ol-or: the kernel keeps a ring of the
// last G+1 diagonals of M/X/Y. Edge offsets, log-weights and open
// penalties are runtime arrays per row (left) and per column (right),
// so any fan-in K and any ring depth G are accepted; the Pallas caps
// (4-bit offsets, 4 right slots, 8-bit code fields) do not exist here.
//
// Candidate order and f32 add order are the reference's exactly, with
// strict first-wins updates:
//   X per left edge slot k:  x + gextj[j], y + lgo, (m + lng) + lopen
//   Y per right edge slot k: y + gexti[i], x + lgo, (m + lng) + ropen
//   M left slot outer, right slot inner; base = ((lng + ms) + llw) + rlw;
//     (m + lng) + base, x + base, y + base
// Codes use the scan cores' uint32 layout bm | bx << 16 | by << 24 with
// bm = (kl * KR + kr) * 3 + move (NONE 65535) and bx/by = k * 3 + move
// (NONE 255); a cell whose best candidate is -inf gets NONE. The (0, 0)
// seed is set on diagonal 0; the ring's last G diagonals are copied out
// at each job's corner diagonal L + R - 2 for the host end corner.
//
// Window: diagonal d holds rows [ilo[d], ilo[d] + W); a source outside
// its own diagonal's window reads -inf, as does any out-of-band cell.
// Full width is ilo = 0, W = the row count.
//
// What bounds it on an H100: the serial chain of D = L + R - 1
// diagonals of one job, each ending in a block barrier, one block per
// job (the main path launches one job at a time). Bytes (4 B of code
// per cell) and operations (~2 per candidate) are thousands of times
// below the card's rates. So a step costs the latency of its longest
// chain of dependent reads when the window is one warp, and the issue
// of its instructions (cells x instructions per cell over the SM's four
// schedulers) when it is tens of warps. The first version's step took
// 2.4-4 us: per candidate a device-memory read of the source
// diagonal's window start ilo[e] and an integer division e % (G+1)
// before the ring read; per cell the band, edge, gap and state words
// and then the match table, all loaded after the barrier; candidate
// loops over a runtime K that the compiler could not unroll. The design
// takes out each of these:
//  1. Per-diagonal addressing once. A shared ring of the last G+1
//     window starts is written with each diagonal, and the ring slots
//     advance by a counter: a source costs one shared read and one
//     compare, no division.
//  2. Inputs staged ahead of the step. A thread's cells form a fixed
//     sequence (its window positions, diagonal after diagonal); the
//     band, state, gap and edge words of the next cell (of the cell
//     after it in a block of at most 256 threads, whose registers hold
//     three cells) are loaded into registers before the current cell is
//     computed, so they are in flight across the barrier. The nf x nf
//     match table sits in shared memory from the job's start.
//  3. Compile-time fan-in. The kernel is templated on (KL, KR) for
//     1..4 x 1..4: the candidate loops unroll and the edge words live in
//     registers. Every row and column but the first has an edge in
//     slot 0 and few have more, so the sources of slot 0 and of the
//     pair (0, 0) are read without a branch, all in flight together,
//     and each other slot costs a warp one untaken branch. A fan-in
//     past 4 runs the group build (note 5).
//  4. Hot diagonals on chip. When the whole ring (12 (G+1) W bytes)
//     does not fit in the 227 KB of shared memory, the newest H >= 3
//     diagonals stay there (offset-1 gaps read d-1, offset-2 matches
//     d-2) and every diagonal is also written to a global ring, which
//     only the older sources (offset >= H) and the corner snapshot
//     read. Only a window wider than ~6,000 rows keeps no diagonal on
//     chip.
//  5. The group build, for a fan-in past 4 x 4 on either side (every
//     --pileup --homopolymer fill: K up to 13 x 12, rings of 20-26
//     diagonals, W 32-96). The first runtime-K step walked all KL slots
//     for X, all KR for Y and all KL x KR slot pairs for M, one after
//     another, each pair reading its edge words again through the L1
//     and branching on an empty slot: ~13 us a diagonal. In a pileup
//     most rows and columns have one live slot (offset in 1..G) and a
//     few have ten, so a cell has 3 to ~130 candidate sources. The
//     group build
//     - gives each window position a group of S lanes of one warp (S a
//       power of two up to 32; the block is ceil(W / rows) groups);
//     - stages, at the job's start, each row's and column's words (band,
//       state, gap extension, live-slot count) and its LIVE slots only
//       (offset, slot index k, log-weight, open penalty: 16 bytes) in
//       shared memory beside the ring or, where they do not fit, in a
//       global scratch read through the L1 (the plan says which);
//     - deals a cell's nl X and nr Y slots, then its nl x nr M slot
//       pairs, over the group's lanes (a pair's index split into its
//       slots by a multiply-high with the column's reciprocal, exact at
//       these sizes), a lane's pairs two at a time so that the reads
//       of both are in flight together; each lane keeps its own best
//       value and code per state;
//     - combines the lanes' (value, code) pairs with a shuffle
//       butterfly that keeps the larger value and, on equal values,
//       the lower code.
//     That is the reference's strict first-wins scan: its candidate
//     order is the order of the codes (X and Y 3k + move, M
//     (kl KR + kr) 3 + move); a lane meets its candidates in rising
//     code order and updates on strictly greater values only; no
//     candidate is NaN (no input is +inf, so no sum is inf - inf); a
//     skipped slot (empty, or offset past G) gives the reference only
//     -inf candidates, which never win; and a value travels with its
//     code, so of two equal values (+0 and -0 too) the lower code's
//     bits survive. A lane that meets nothing above -inf keeps NONE,
//     and a cell whose best is -inf gets NONE as before. Each
//     candidate keeps the reference's f32 add order. The ring, the
//     window-start ring, one barrier a diagonal, the code layout and
//     the corner snapshot are the templated builds'.
//     On the H100 (tools/bench_fanin.py --groups on the pileup calls,
//     PERF.md) 8 lanes a group were fastest at W 32-96 (4 close, 16 and
//     32 slower: more warps at the barrier, more shuffle rounds). Of
//     variants timed on the same calls, one list of X, Y and M sources
//     a lane was slower than the M pairs dealt apart, two in flight;
//     three or four in flight, or the next cell's words staged across
//     the barrier, were slower again.
// The launch plan (build, H, threads, cells staged ahead or lanes a
// group and rows a group, where the group build's tables live, shared
// bytes) is a function of (W, G, KL, KR, nf, Lr, Rr) in the wrapper,
// viterbi_fanin.py::launch_plan, and is only checked here; a window of
// one warp synchronises with __syncwarp.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

struct FaninArgs {
  const int* lstate;    // (B, Lr)
  const int* rstate;    // (B, Rr)
  const float* table;   // (B, nf, nf)
  const int* loff;      // (B, Lr, KL)
  const float* llw;     // (B, Lr, KL)
  const float* lopen;   // (B, Lr, KL)
  const float* gexti;   // (B, Lr)
  const int* bup;       // (B, Lr) band upper (first valid column)
  const int* blo;       // (B, Lr) band lower (last valid column)
  const int* roff;      // (B, Rr, KR)
  const float* rlw;     // (B, Rr, KR)
  const float* ropen;   // (B, Rr, KR)
  const float* gextj;   // (B, Rr)
  const int* ilo;       // (B, D) window start per diagonal
  const float* fscal;   // (B, 2): lng, lgo
  const int* iscal;     // (B, 2): L, R
  uint32_t* bp;         // (B, D, W)
  float* snap;          // (B, 3, G, W)
  float* gring;         // (B, 3, G+1, W) when H < G+1
  int4* tabs;           // group build: its tables when not in shared
  int D, W, G, Lr, Rr, KL, KR, nf;
  int H;                // diagonals kept in shared memory (G+1: all)
};

constexpr uint32_t BM_NONE = 65535u;
constexpr uint32_t BXY_NONE = 255u;

// The inputs of one cell (i, j). Outside the matrix bup is INT_MAX, so
// the band test fails.
template <int KLT, int KRT>
struct Cell {
  int i, j, bup, blo, ls, rs;
  float gxi, gjx;
  int loff[KLT];
  float llw[KLT], lopen[KLT];
  int roff[KRT];
  float rlw[KRT], ropen[KRT];
};

// one job's input rows (pointers offset to the job)
struct Job {
  const int *lstate, *rstate, *loff, *bup, *blo, *roff;
  const float *llw, *lopen, *gexti, *rlw, *ropen, *gextj;
  int L, R;
};

template <int KLT, int KRT>
__device__ __forceinline__ void load_cell(Cell<KLT, KRT>& c, const Job& jb,
                                          int i, int j) {
  c.i = i;
  c.j = j;
  c.bup = 0x7fffffff;
  c.blo = 0;
  c.ls = c.rs = 0;
  c.gxi = c.gjx = 0.0f;
  if (i < jb.L && j >= 0 && j < jb.R) {
    c.bup = __ldg(jb.bup + i);
    c.blo = __ldg(jb.blo + i);
    c.ls = __ldg(jb.lstate + i);
    c.rs = __ldg(jb.rstate + j);
    c.gxi = __ldg(jb.gexti + i);
    c.gjx = __ldg(jb.gextj + j);
#pragma unroll
    for (int k = 0; k < KLT; ++k) {
      c.loff[k] = __ldg(jb.loff + i * KLT + k);
      c.llw[k] = __ldg(jb.llw + i * KLT + k);
      c.lopen[k] = __ldg(jb.lopen + i * KLT + k);
    }
#pragma unroll
    for (int k = 0; k < KRT; ++k) {
      c.roff[k] = __ldg(jb.roff + j * KRT + k);
      c.rlw[k] = __ldg(jb.rlw + j * KRT + k);
      c.ropen[k] = __ldg(jb.ropen + j * KRT + k);
    }
  }
}

// KLT, KRT: the fan-in (1..4 each). ALLSH:
// the whole ring in shared memory (H == G + 1). MAXT: the largest block
// it is launched with (sets the register budget). PF: how many cells
// ahead a thread stages its inputs (1, or 2 for blocks of at most 256
// threads, whose registers hold a third buffer).
template <int KLT, int KRT, bool ALLSH, int MAXT, int PF>
__global__ void __launch_bounds__(MAXT) viterbi_fanin_kernel(FaninArgs a) {
  extern __shared__ __align__(16) float sh[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int W = a.W, G = a.G, GR = a.G + 1, D = a.D, H = a.H, nf = a.nf;
  constexpr int KL = KLT, KR = KRT;
  const float NEG = -CUDART_INF_F;
  // shared: hot ring [M, X, Y][H][W], match table, window-start ring
  float* hot = sh;
  float* tab = sh + (size_t)3 * H * W;
  int* silo = reinterpret_cast<int*>(tab + nf * nf);
  float* gr = H < GR ? a.gring + (size_t)b * 3 * GR * W : nullptr;
  const float lng = a.fscal[b * 2 + 0];
  const float lgo = a.fscal[b * 2 + 1];
  Job jb;
  jb.L = a.iscal[b * 2 + 0];
  jb.R = a.iscal[b * 2 + 1];
  jb.lstate = a.lstate + (size_t)b * a.Lr;
  jb.rstate = a.rstate + (size_t)b * a.Rr;
  jb.loff = a.loff + (size_t)b * a.Lr * KL;
  jb.llw = a.llw + (size_t)b * a.Lr * KL;
  jb.lopen = a.lopen + (size_t)b * a.Lr * KL;
  jb.gexti = a.gexti + (size_t)b * a.Lr;
  jb.bup = a.bup + (size_t)b * a.Lr;
  jb.blo = a.blo + (size_t)b * a.Lr;
  jb.roff = a.roff + (size_t)b * a.Rr * KR;
  jb.rlw = a.rlw + (size_t)b * a.Rr * KR;
  jb.ropen = a.ropen + (size_t)b * a.Rr * KR;
  jb.gextj = a.gextj + (size_t)b * a.Rr;
  const int cornerd = jb.L + jb.R - 2;
  const int* ilo = a.ilo + (size_t)b * D;
  const float* table = a.table + (size_t)b * nf * nf;
  uint32_t* bpb = a.bp + (size_t)b * D * W;
  float* snapb = a.snap + (size_t)b * 3 * G * W;
  const bool one_warp = nt <= 32;

  for (int q = tid; q < nf * nf; q += nt) tab[q] = table[q];
  if (one_warp) __syncwarp(); else __syncthreads();

  // slot of diagonal d in the full ring (sg) and in the hot ring (shs);
  // sp: the slot of diagonal d - 1, which no thread writes in step d
  int sg = 0, shs = 0, sp = G;
  int d = 0;
  // value of M/X/Y at diagonal d - o, global row r; -inf where `ok` is
  // false, before diagonal 0 or outside that diagonal's window. With
  // the whole ring on chip there is no branch (every address read is
  // valid), so the compiler issues a cell's source reads together; a
  // split ring branches between the hot slots and the global ring,
  // which measured faster on the H100 than reading both. A source that
  // is not read still reads slot sp (or slot s for one outside its
  // window), never the slot that step d writes: the throwaway reads do
  // not race with the step's writes.
  auto fetch = [&](bool ok, int o, int r, float& vm, float& vx,
                   float& vy) {
    ok = ok && o <= d;
    int s = sg - o;
    s += s < 0 ? GR : 0;
    s = ok ? s : sp;
    const int rel = r - silo[s];
    const bool in = ok && rel >= 0 && rel < W;
    if constexpr (ALLSH) {
      const float* p = hot + s * W + (in ? rel : 0);
      const float pm = p[0], px = p[H * W], py = p[2 * H * W];
      vm = in ? pm : NEG;
      vx = in ? px : NEG;
      vy = in ? py : NEG;
    } else {
      vm = vx = vy = NEG;
      if (in) {
        if (o < H) {
          int h = shs - o;
          h += h < 0 ? H : 0;
          const float* p = hot + h * W + rel;
          vm = p[0]; vx = p[H * W]; vy = p[2 * H * W];
        } else {
          const float* q = gr + (size_t)s * W + rel;
          vm = q[0]; vx = q[(size_t)GR * W]; vy = q[(size_t)2 * GR * W];
        }
      }
    }
  };

  // The thread's cells in order: window positions tid, tid + nt, ...
  // of diagonal 0, then of diagonal 1, and so on. The cell PF places
  // ahead of the current one, (dq, tq), is staged into registers before
  // the current one is computed. With PF = 1 the staged cell is copied
  // into the current one; with PF = 2 the three buffers take turns (on
  // the H100 turns were faster for narrow blocks, and slower than the
  // copy where a block of up to 1024 threads runs short of registers).
  Cell<KLT, KRT> c0, c1, c2;
  int ilo_d = ilo[0];
  int ilo_n = D > 1 ? ilo[1] : 0;
  int ilo_nn = D > 2 ? ilo[2] : 0;
  int dq = 0, tq = tid;
  // stage cell (dq, tq), of diagonal dq <= d + 2, into `c`; move on
  auto stage = [&](Cell<KLT, KRT>& c) {
    if (dq < D) {
      const int il = dq == d ? ilo_d : dq == d + 1 ? ilo_n : ilo_nn;
      load_cell(c, jb, il + tq, dq - il - tq);
    }
    if (tq + nt < W) {
      tq += nt;
    } else {
      tq = tid;
      ++dq;
    }
  };
  // stage the cell PF ahead into `ahead`, then compute cell `c`:
  // window position t of diagonal d
  auto step = [&](const Cell<KLT, KRT>& c, Cell<KLT, KRT>& ahead,
                  int t) {
    stage(ahead);
    const int i = c.i, j = c.j;
    float M = NEG, X = NEG, Y = NEG;
    uint32_t cm = BM_NONE, cx = BXY_NONE, cy = BXY_NONE;
    if (j >= c.bup && j <= c.blo) {
      // Every row and column but the first has an edge in slot 0, and
      // few have more: the sources of slot 0 and of the slot pair
      // (0, 0) are read together, without a branch; the other slots
      // read theirs behind a branch that a warp seldom takes.
      const bool ij = i > 0 && j > 0;
      const int ol0 = c.loff[0], or0 = c.roff[0];
      float xm, xx, xy, ym, yx, yy, mm, mx, my;
      fetch(ol0 > 0 && ol0 <= G, ol0, i - ol0, xm, xx, xy);
      fetch(or0 > 0 && or0 <= G, or0, i, ym, yx, yy);
      fetch(ij && ol0 > 0 && or0 > 0 && ol0 + or0 <= G, ol0 + or0,
            i - ol0, mm, mx, my);
      float vm, vx, vy, v;
      // ---- X: gap consuming left site i ----
      float bestX = NEG;
      uint32_t codeX = BXY_NONE;
#pragma unroll
      for (int k = 0; k < KL; ++k) {
        if (k == 0) {
          vm = xm; vx = xx; vy = xy;
        } else {
          const int o = c.loff[k];
          if (o <= 0 || o > G) continue;
          fetch(true, o, i - o, vm, vx, vy);
        }
        v = vx + c.gjx;
        if (v > bestX) { bestX = v; codeX = 3 * k; }
        v = vy + lgo;
        if (v > bestX) { bestX = v; codeX = 3 * k + 1; }
        v = (vm + lng) + c.lopen[k];
        if (v > bestX) { bestX = v; codeX = 3 * k + 2; }
      }
      // ---- Y: gap consuming right site j ----
      float bestY = NEG;
      uint32_t codeY = BXY_NONE;
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        if (k == 0) {
          vm = ym; vx = yx; vy = yy;
        } else {
          const int o = c.roff[k];
          if (o <= 0 || o > G) continue;
          fetch(true, o, i, vm, vx, vy);
        }
        v = vy + c.gxi;
        if (v > bestY) { bestY = v; codeY = 3 * k; }
        v = vx + lgo;
        if (v > bestY) { bestY = v; codeY = 3 * k + 1; }
        v = (vm + lng) + c.ropen[k];
        if (v > bestY) { bestY = v; codeY = 3 * k + 2; }
      }
      // ---- M: match (left slot outer, right slot inner) ----
      float bestM = NEG;
      uint32_t codeM = BM_NONE;
      const float mbase = lng + tab[c.ls * nf + c.rs];
#pragma unroll
      for (int kl = 0; kl < KL; ++kl) {
        const int ol = c.loff[kl];
        const float lb = mbase + c.llw[kl];
#pragma unroll
        for (int kr = 0; kr < KR; ++kr) {
          if (kl + kr == 0) {
            vm = mm; vx = mx; vy = my;
          } else {
            const int orr = c.roff[kr];
            if (!ij || ol <= 0 || orr <= 0 || ol + orr > G) continue;
            fetch(true, ol + orr, i - ol, vm, vx, vy);
          }
          const float base = lb + c.rlw[kr];
          const uint32_t pair = (uint32_t)((kl * KR + kr) * 3);
          v = (vm + lng) + base;
          if (v > bestM) { bestM = v; codeM = pair; }
          v = vx + base;
          if (v > bestM) { bestM = v; codeM = pair + 1; }
          v = vy + base;
          if (v > bestM) { bestM = v; codeM = pair + 2; }
        }
      }
      if (i > 0 && bestX > NEG) { X = bestX; cx = codeX; }
      if (j > 0 && bestY > NEG) { Y = bestY; cy = codeY; }
      if (i > 0 && j > 0 && bestM > NEG) { M = bestM; cm = codeM; }
    }
    if (i == 0 && j == 0) M = 0.0f;     // seed cell on diagonal 0
    if (H > 0) {
      float* p = hot + (size_t)shs * W + t;
      p[0] = M;
      p[(size_t)H * W] = X;
      p[(size_t)2 * H * W] = Y;
    }
    if (H < GR) {
      float* p = gr + (size_t)sg * W + t;
      p[0] = M;
      p[(size_t)GR * W] = X;
      p[(size_t)2 * GR * W] = Y;
    }
    bpb[(size_t)d * W + t] = cm | (cx << 16) | (cy << 24);
  };

  if (tid < W) {
    stage(c0);
    if constexpr (PF == 2) stage(c1);
  }
  int ph = 0;   // PF = 2: the buffer of the current cell
  for (d = 0; d < D; ++d) {
    const int ilo_n3 = d + 3 < D ? ilo[d + 3] : 0;
    for (int t = tid; t < W; t += nt) {
      if constexpr (PF == 1) {
        step(c0, c1, t);
        c0 = c1;
      } else {
        if (ph == 0) step(c0, c2, t);
        else if (ph == 1) step(c1, c0, t);
        else step(c2, c1, t);
        ph = ph == 2 ? 0 : ph + 1;
      }
    }
    // slot sg of the window-start ring is read again only as diagonal
    // d itself, from step d + 1 on
    if (tid == 0) silo[sg] = ilo_d;
    if (one_warp) __syncwarp(); else __syncthreads();
    if (d == cornerd) {
      // snap[g] = diagonal d - g, from the shared ring when it holds
      // all G+1 slots, else from the global ring; the slots read here
      // are rewritten only from step d + 1 on, and hold diagonal d - G
      // then, which is not read
      const float* ring = H == GR ? hot : gr;
      for (int q = tid; q < 3 * G * W; q += nt) {
        const int mat = q / (G * W);
        const int g = (q / W) % G;
        const int t = q % W;
        int s = sg - g;
        if (s < 0) s += GR;
        snapb[q] = d - g < 0 ? NEG
                             : ring[((size_t)mat * GR + s) * W + t];
      }
    }
    ilo_d = ilo_n;
    ilo_n = ilo_nn;
    ilo_nn = ilo_n3;
    sp = sg;
    sg = sg + 1 == GR ? 0 : sg + 1;
    if (H > 0) shs = shs + 1 == H ? 0 : shs + 1;
  }
  // a job whose corner lies beyond the launch's diagonals (never the
  // case for launches built by the port) keeps an all -inf snapshot
  if (cornerd < 0 || cornerd >= D) {
    for (int q = tid; q < 3 * G * W; q += nt) snapb[q] = NEG;
  }
}

template <int KLT, int KRT, bool ALLSH, int MAXT, int PF>
int launch1(const FaninArgs& a, int B, int threads, size_t smem,
            cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_fanin_kernel<KLT, KRT, ALLSH, MAXT, PF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_fanin_kernel<KLT, KRT, ALLSH, MAXT, PF>
      <<<B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KLT, int KRT, int MAXT, int PF>
int launch2(const FaninArgs& a, int B, int threads, size_t smem,
            cudaStream_t stream) {
  return a.H == a.G + 1
             ? launch1<KLT, KRT, true, MAXT, PF>(a, B, threads, smem, stream)
             : launch1<KLT, KRT, false, MAXT, PF>(a, B, threads, smem,
                                                  stream);
}

// The instantiations of one fan-in: ahead = 2 is built for blocks of
// at most 256 threads, ahead = 1 for blocks of at most MAXT. The plan
// (ahead, threads) is launch_plan's; one that no instantiation takes
// is refused.
template <int KLT, int KRT, int MAXT>
int launch(const FaninArgs& a, int B, int threads, int ahead, size_t smem,
           cudaStream_t stream) {
  if (ahead == 2 && threads <= 256)
    return launch2<KLT, KRT, 256, 2>(a, B, threads, smem, stream);
  if (ahead == 1 && threads <= MAXT)
    return launch2<KLT, KRT, MAXT, 1>(a, B, threads, smem, stream);
  return (int)cudaErrorInvalidValue;
}

// a templated fan-in past 2 x 2 stages more edge words a cell, so its
// register budget allows blocks of at most 512 threads
template <int KLT, int KRT>
int launch_k(const FaninArgs& a, int B, int threads, int ahead,
             size_t smem, cudaStream_t stream) {
  constexpr int MAXT = (KLT <= 2 && KRT <= 2) ? 1024 : 512;
  return launch<KLT, KRT, MAXT>(a, B, threads, ahead, smem, stream);
}

#define FANIN_ROW(kl)                                                   \
  case kl:                                                              \
    switch (krt) {                                                      \
      case 1: return launch_k<kl, 1>(a, B, threads, ahead, smem, stream); \
      case 2: return launch_k<kl, 2>(a, B, threads, ahead, smem, stream); \
      case 3: return launch_k<kl, 3>(a, B, threads, ahead, smem, stream); \
      case 4: return launch_k<kl, 4>(a, B, threads, ahead, smem, stream); \
      default: return (int)cudaErrorInvalidValue;                       \
    }

int dispatch(const FaninArgs& a, int klt, int krt, int B, int threads,
             int ahead, size_t smem, cudaStream_t stream) {
  if (klt != a.KL || krt != a.KR) return (int)cudaErrorInvalidValue;
  switch (klt) {
    FANIN_ROW(1)
    FANIN_ROW(2)
    FANIN_ROW(3)
    FANIN_ROW(4)
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- the group build (design note 5) ----

// the group build's tables, 16 bytes an entry: per row its band, state
// and live-slot count (ls | n << 16) and gap extension; per column its
// state and live-slot count, gap extension and the reciprocal of the
// count (2^32 / n rounded up, for n > 1); per row KL and per column KR
// slots, the live ones first, in slot order
struct __align__(16) RowWords {
  int bup, blo, ls_n;
  float gext;
};
struct __align__(16) ColWords {
  int rs_n;
  float gext;
  unsigned magic;
  int pad;
};
struct __align__(16) Slot {
  int off, k;
  float lw, open;
};

// 16-byte entries of one job's tables
__host__ __device__ inline size_t table_units(int Lr, int Rr, int KL,
                                              int KR) {
  return (size_t)Lr + Rr + (size_t)Lr * KL + (size_t)Rr * KR;
}

// floats before the tables in shared memory: hot ring, match table and
// window-start ring, rounded up to 16 bytes
__host__ __device__ inline size_t tables_at(int H, int W, int nf, int G) {
  return ((size_t)3 * H * W + (size_t)nf * nf + G + 1 + 3) & ~(size_t)3;
}

// keep the better of two (value, code) candidates: the larger value,
// the lower code on equal values
__device__ __forceinline__ void better(float& v, uint32_t& c, float ov,
                                       uint32_t oc) {
  if (ov > v || (ov == v && oc < c)) {
    v = ov;
    c = oc;
  }
}

// S: lanes a group (a power of two, 1..32). ALLSH: the whole ring in
// shared memory. TABSH: the tables in shared memory (else in a.tabs).
// Every thread runs `rows` cells a diagonal (a dummy one past the
// window), so the group's shuffles always see the whole warp.
template <int S, bool ALLSH, bool TABSH>
__global__ void __launch_bounds__(1024)
    viterbi_fanin_groups_kernel(FaninArgs a, int rows) {
  extern __shared__ __align__(16) float sh[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid % S, grp = tid / S, ng = nt / S;
  const int W = a.W, G = a.G, GR = a.G + 1, D = a.D, H = a.H, nf = a.nf;
  const int Lr = a.Lr, Rr = a.Rr, KL = a.KL, KR = a.KR;
  const float NEG = -CUDART_INF_F;
  float* hot = sh;
  float* tab = sh + (size_t)3 * H * W;
  int* silo = reinterpret_cast<int*>(tab + nf * nf);
  int4* tabs = TABSH ? reinterpret_cast<int4*>(sh + tables_at(H, W, nf, G))
                     : a.tabs + (size_t)b * table_units(Lr, Rr, KL, KR);
  RowWords* rw = reinterpret_cast<RowWords*>(tabs);
  ColWords* cw = reinterpret_cast<ColWords*>(tabs + Lr);
  Slot* lsl = reinterpret_cast<Slot*>(tabs + Lr + Rr);
  Slot* rsl = lsl + (size_t)Lr * KL;
  float* gr = H < GR ? a.gring + (size_t)b * 3 * GR * W : nullptr;
  const float lng = a.fscal[b * 2 + 0];
  const float lgo = a.fscal[b * 2 + 1];
  const int L = a.iscal[b * 2 + 0];
  const int R = a.iscal[b * 2 + 1];
  const int cornerd = L + R - 2;
  const int* ilo = a.ilo + (size_t)b * D;
  uint32_t* bpb = a.bp + (size_t)b * D * W;
  float* snapb = a.snap + (size_t)b * 3 * G * W;
  const bool one_warp = nt <= 32;

  // prologue: the match table and the tables, each row's and column's
  // live slots (offset in 1..G) first
  {
    const float* table = a.table + (size_t)b * nf * nf;
    for (int q = tid; q < nf * nf; q += nt) tab[q] = table[q];
    const size_t lb = (size_t)b * Lr, rb = (size_t)b * Rr;
    for (int q = tid; q < Lr + Rr; q += nt) {
      const bool left = q < Lr;
      const int x = left ? q : q - Lr;
      const int K = left ? KL : KR;
      const size_t base = (left ? lb + x : rb + x) * K;
      const int* off = left ? a.loff : a.roff;
      const float* lw = left ? a.llw : a.rlw;
      const float* op = left ? a.lopen : a.ropen;
      Slot* out = (left ? lsl : rsl) + (size_t)x * K;
      int n = 0;
      for (int k = 0; k < K; ++k) {
        const int o = __ldg(off + base + k);
        if (o > 0 && o <= G) {
          out[n] = Slot{o, k, __ldg(lw + base + k), __ldg(op + base + k)};
          ++n;
        }
      }
      if (left) {
        rw[x] = RowWords{__ldg(a.bup + lb + x), __ldg(a.blo + lb + x),
                         (__ldg(a.lstate + lb + x) & 0xffff) | n << 16,
                         __ldg(a.gexti + lb + x)};
      } else {
        cw[x] = ColWords{(__ldg(a.rstate + rb + x) & 0xffff) | n << 16,
                         __ldg(a.gextj + rb + x),
                         n > 1 ? 0xffffffffu / (unsigned)n + 1u : 0u, 0};
      }
    }
  }
  __syncthreads();

  int sg = 0, shs = 0;   // slot of diagonal d in the full and hot rings
  int d = 0;
  // M/X/Y at diagonal d - o (1 <= o <= G), global row r: -inf where
  // `ok` is false, before diagonal 0 or outside that diagonal's window.
  // Slot sg, which step d writes, is never read (o >= 1).
  auto fetch = [&](bool ok, int o, int r, float& vm, float& vx,
                   float& vy) {
    o = ok ? o : 1;
    int s = sg - o;
    s += s < 0 ? GR : 0;
    const int rel = r - silo[s];
    const bool in = ok && o <= d && rel >= 0 && rel < W;
    if constexpr (ALLSH) {
      const float* p = hot + s * W + (in ? rel : 0);
      const float pm = p[0], px = p[H * W], py = p[2 * H * W];
      vm = in ? pm : NEG;
      vx = in ? px : NEG;
      vy = in ? py : NEG;
    } else {
      vm = vx = vy = NEG;
      if (in) {
        if (o < H) {
          int h = shs - o;
          h += h < 0 ? H : 0;
          const float* p = hot + h * W + rel;
          vm = p[0]; vx = p[H * W]; vy = p[2 * H * W];
        } else {
          const float* p = gr + (size_t)s * W + rel;
          vm = p[0]; vx = p[(size_t)GR * W]; vy = p[(size_t)2 * GR * W];
        }
      }
    }
  };

  int ilo_d = ilo[0];
  int ilo_n = D > 1 ? ilo[1] : 0;
  for (d = 0; d < D; ++d) {
    const int ilo_nn = d + 2 < D ? ilo[d + 2] : 0;
    for (int rr = 0; rr < rows; ++rr) {
      const int t = grp + rr * ng;
      const int i = ilo_d + t, j = d - i;
      float bX = NEG, bY = NEG, bM = NEG;
      uint32_t cX = BXY_NONE, cY = BXY_NONE, cM = BM_NONE;
      bool live = t < W && (unsigned)i < (unsigned)L &&
                  (unsigned)j < (unsigned)R;
      RowWords ri;
      ColWords cj;
      if (live) {
        ri = rw[i];
        cj = cw[j];
        live = j >= ri.bup && j <= ri.blo;
      }
      if (live) {
        const int nl = ri.ls_n >> 16, nr = cj.rs_n >> 16;
        const int nx = nl + nr;
        const float mbase = lng + tab[(ri.ls_n & 0xffff) * nf +
                                      (cj.rs_n & 0xffff)];
        // X and Y: the row's live slots, then the column's
        for (int q = lane; q < nx; q += S) {
          const bool xs = q < nl;
          const Slot e = *(xs ? lsl + (size_t)i * KL + q
                              : rsl + (size_t)j * KR + (q - nl));
          float vm, vx, vy;
          fetch(true, e.off, xs ? i - e.off : i, vm, vx, vy);
          const float c0 = xs ? vx + cj.gext : vy + ri.gext;
          const float c1 = (xs ? vy : vx) + lgo;
          const float c2 = (vm + lng) + e.open;
          const uint32_t code = 3u * e.k;
          float bv = xs ? bX : bY;
          uint32_t bc = xs ? cX : cY;
          if (c0 > bv) { bv = c0; bc = code; }
          if (c1 > bv) { bv = c1; bc = code + 1; }
          if (c2 > bv) { bv = c2; bc = code + 2; }
          if (xs) { bX = bv; cX = bc; } else { bY = bv; cY = bc; }
        }
        // M: slot pairs (left slot outer, right slot inner), two a
        // lane in flight at a time
        const int nm = nl * nr;
        auto pair = [&](unsigned p, int& o, int& r, float& base,
                        uint32_t& code) {
          const unsigned al = nr == 1 ? p : __umulhi(p, cj.magic);
          const Slot el = lsl[(size_t)i * KL + al];
          const Slot er = rsl[(size_t)j * KR + (p - al * nr)];
          o = el.off + er.off;
          r = i - el.off;
          base = (mbase + el.lw) + er.lw;
          code = (uint32_t)((el.k * KR + er.k) * 3);
        };
        auto take = [&](float vm, float vx, float vy, float base,
                        uint32_t code) {
          const float c0 = (vm + lng) + base, c1 = vx + base,
                      c2 = vy + base;
          if (c0 > bM) { bM = c0; cM = code; }
          if (c1 > bM) { bM = c1; cM = code + 1; }
          if (c2 > bM) { bM = c2; cM = code + 2; }
        };
        for (int p = lane; p < nm; p += 2 * S) {
          const bool two = p + S < nm;
          int oa, ra, ob, rb;
          float ba, bb;
          uint32_t ca, cb;
          pair(p, oa, ra, ba, ca);
          pair(two ? p + S : p, ob, rb, bb, cb);
          float ma, xa, ya, mb, xb, yb;
          fetch(oa <= G, oa, ra, ma, xa, ya);
          fetch(two && ob <= G, ob, rb, mb, xb, yb);
          take(ma, xa, ya, ba, ca);
          take(mb, xb, yb, bb, cb);
        }
      }
#pragma unroll
      for (int m = S / 2; m >= 1; m >>= 1) {
        better(bX, cX, __shfl_xor_sync(0xffffffffu, bX, m, S),
               __shfl_xor_sync(0xffffffffu, cX, m, S));
        better(bY, cY, __shfl_xor_sync(0xffffffffu, bY, m, S),
               __shfl_xor_sync(0xffffffffu, cY, m, S));
        better(bM, cM, __shfl_xor_sync(0xffffffffu, bM, m, S),
               __shfl_xor_sync(0xffffffffu, cM, m, S));
      }
      if (lane == 0 && t < W) {
        float M = NEG, X = NEG, Y = NEG;
        uint32_t cm = BM_NONE, cx = BXY_NONE, cy = BXY_NONE;
        if (i > 0 && bX > NEG) { X = bX; cx = cX; }
        if (j > 0 && bY > NEG) { Y = bY; cy = cY; }
        if (i > 0 && j > 0 && bM > NEG) { M = bM; cm = cM; }
        if (i == 0 && j == 0) M = 0.0f;     // seed cell on diagonal 0
        if (H > 0) {
          float* p = hot + (size_t)shs * W + t;
          p[0] = M;
          p[(size_t)H * W] = X;
          p[(size_t)2 * H * W] = Y;
        }
        if (H < GR) {
          float* p = gr + (size_t)sg * W + t;
          p[0] = M;
          p[(size_t)GR * W] = X;
          p[(size_t)2 * GR * W] = Y;
        }
        bpb[(size_t)d * W + t] = cm | (cx << 16) | (cy << 24);
      }
    }
    if (tid == 0) silo[sg] = ilo_d;
    if (one_warp) __syncwarp(); else __syncthreads();
    if (d == cornerd) {
      const float* ring = H == GR ? hot : gr;
      for (int q = tid; q < 3 * G * W; q += nt) {
        const int mat = q / (G * W);
        const int g = (q / W) % G;
        const int t = q % W;
        int s = sg - g;
        if (s < 0) s += GR;
        snapb[q] = d - g < 0 ? NEG
                             : ring[((size_t)mat * GR + s) * W + t];
      }
    }
    ilo_d = ilo_n;
    ilo_n = ilo_nn;
    sg = sg + 1 == GR ? 0 : sg + 1;
    if (H > 0) shs = shs + 1 == H ? 0 : shs + 1;
  }
  if (cornerd < 0 || cornerd >= D) {
    for (int q = tid; q < 3 * G * W; q += nt) snapb[q] = NEG;
  }
}

template <int S, bool ALLSH, bool TABSH>
int launch_groups1(const FaninArgs& a, int B, int threads, int rows,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_fanin_groups_kernel<S, ALLSH, TABSH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_fanin_groups_kernel<S, ALLSH, TABSH>
      <<<B, threads, smem, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

template <int S>
int launch_groups(const FaninArgs& a, int B, int threads, int rows,
                  bool tabsh, size_t smem, cudaStream_t stream) {
  const bool allsh = a.H == a.G + 1;
  if (allsh)
    return tabsh ? launch_groups1<S, true, true>(a, B, threads, rows, smem,
                                                 stream)
                 : launch_groups1<S, true, false>(a, B, threads, rows, smem,
                                                  stream);
  return tabsh ? launch_groups1<S, false, true>(a, B, threads, rows, smem,
                                                stream)
               : launch_groups1<S, false, false>(a, B, threads, rows, smem,
                                                 stream);
}

// the group build (launch_plan's for a fan-in past 4 x 4; it takes any
// fan-in up to 1,024 a side): a plan of S lanes a group
// (1..32, a power of two), whole warps of whole groups that cover the
// window in `rows` cells a group, and shared memory for the ring, the
// match table, the window-start ring and, with tabsh, the tables
int dispatch_groups(const FaninArgs& a, int B, int threads, int group,
                    int rows, int tabsh, size_t smem, cudaStream_t stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || rows < 1 ||
      group < 1 || group > 32 || (group & (group - 1)) ||
      (long long)(threads / group) * rows < a.W ||
      a.KL > 1024 || a.KR > 1024)
    return (int)cudaErrorInvalidValue;
  if (tabsh ? smem < 4 * tables_at(a.H, a.W, a.nf, a.G) +
                         16 * table_units(a.Lr, a.Rr, a.KL, a.KR)
            : a.tabs == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (group) {
    case 1: return launch_groups<1>(a, B, threads, rows, tabsh, smem, stream);
    case 2: return launch_groups<2>(a, B, threads, rows, tabsh, smem, stream);
    case 4: return launch_groups<4>(a, B, threads, rows, tabsh, smem, stream);
    case 8: return launch_groups<8>(a, B, threads, rows, tabsh, smem, stream);
    case 16:
      return launch_groups<16>(a, B, threads, rows, tabsh, smem, stream);
    default:
      return launch_groups<32>(a, B, threads, rows, tabsh, smem, stream);
  }
}

}  // namespace

// The launch plan, as viterbi_fanin.py::launch_plan computes it: klt,
// krt: the templated fan-in to launch (0, 0: the group build); hot:
// diagonals kept in shared memory (G + 1: the whole ring; fewer: the
// rest in gring); threads: the block; ahead: cells a thread stages
// ahead (1 or 2; templated builds); group, rows: lanes a group and
// cells a group a diagonal (group build); tabsh: the group build's
// tables in shared memory (else in tabs, B x table_units entries);
// smem: dynamic shared bytes (hot ring, table, window-start ring, and
// the tables with tabsh).
extern "C" int viterbi_fanin_launch(
    const void* lstate, const void* rstate, const void* table,
    const void* loff, const void* llw, const void* lopen,
    const void* gexti, const void* bup, const void* blo, const void* roff,
    const void* rlw, const void* ropen, const void* gextj, const void* ilo,
    const void* fscal, const void* iscal, void* bp, void* snap,
    void* gring, void* tabs, int B, int D, int W, int G, int Lr, int Rr,
    int KL, int KR, int nf, int hot, int klt, int krt, int threads,
    int ahead, int group, int rows, int tabsh, int smem, void* stream) {
  FaninArgs a;
  a.lstate = (const int*)lstate;
  a.rstate = (const int*)rstate;
  a.table = (const float*)table;
  a.loff = (const int*)loff;
  a.llw = (const float*)llw;
  a.lopen = (const float*)lopen;
  a.gexti = (const float*)gexti;
  a.bup = (const int*)bup;
  a.blo = (const int*)blo;
  a.roff = (const int*)roff;
  a.rlw = (const float*)rlw;
  a.ropen = (const float*)ropen;
  a.gextj = (const float*)gextj;
  a.ilo = (const int*)ilo;
  a.fscal = (const float*)fscal;
  a.iscal = (const int*)iscal;
  a.bp = (uint32_t*)bp;
  a.snap = (float*)snap;
  a.gring = (float*)gring;
  a.tabs = (int4*)tabs;
  a.D = D;
  a.W = W;
  a.G = G;
  a.Lr = Lr;
  a.Rr = Rr;
  a.KL = KL;
  a.KR = KR;
  a.nf = nf;
  a.H = hot;
  if (hot < 0 || hot > G + 1 || (hot <= G && gring == nullptr) ||
      (size_t)smem < ((size_t)3 * hot * W + (size_t)nf * nf + G + 1) * 4)
    return (int)cudaErrorInvalidValue;
  if (klt == 0 && krt == 0)
    return dispatch_groups(a, B, threads, group, rows, tabsh, (size_t)smem,
                           (cudaStream_t)stream);
  return dispatch(a, klt, krt, B, threads, ahead, (size_t)smem,
                  (cudaStream_t)stream);
}
