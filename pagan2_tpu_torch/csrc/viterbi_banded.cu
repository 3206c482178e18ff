// Kernel C: windowed banded linear-chain 3-state (M/X/Y) Viterbi
// wavefront for one anchored long pair.
//
// Replaces the TPU kernel
// pagan2_tpu/align/viterbi_pallas_banded.py::_kernel (launched by
// pallas_banded_fill). Diagonal d = i + j fills only its band window,
// rows [ilo[d], ilo[d] + w[d]); window position t is row i = ilo[d] + t.
// Same recurrence, candidate order, strict first-wins updates and f32
// add order as the Pallas kernel:
//   X at (i, j) from (i-1, j):   ext x + gj(j), double y + lgo,
//                                open (m + lng) + olv(i-1)
//   Y at (i, j) from (i, j-1):   ext y + gei(i), double x + lgo,
//                                open (m + lng) + orv(j-1)
//   M at (i, j) from (i-1, j-1): max(m + lng, x, y) + ms_folded
// with the per-position penalties rebuilt from row and column indices
// against scalars (pair-end break, terminal, interior), and the match
// score pre-folded on the way in as ((ms + lw[i]) + rw[j]) + lng. The
// sources sit at window positions t + sx, t + sy of diagonal d-1 and
// t + sm of diagonal d-2 (offsets from the per-diagonal schedule); a
// source outside [0, Wk) gives no source (code 3) and the state -inf.
// Codes are plain bytes at the TARGET cell (bm bits 0-1, bx 2-3, by
// 4-5), so the Pallas kernel's packed f32 words and source-position
// codes do not exist here.
//
// What bounds it on an H100: not bytes (5 B per window cell against
// 3.35 TB/s) and not operations (~30 f32 add/compare/select per cell
// against 67 TFLOP/s), but the serial chain of D - 1 dependent
// diagonals of one pair (2.1 M for a 1 Mb pair), each a few dozen to a
// few hundred cells wide, with one block on 132 SMs. A step costs what
// one warp takes to dispatch its instructions in order, each waiting on
// the one before (shared read, a dozen dependent adds and maxima,
// shared write), plus the block barrier; the barrier is the smaller
// part (measured on the H100: dropping it saved 0-5%), so the design
// cuts the instructions on a warp's chain and spreads the window's
// cells over more warps (one warp holding 3 or 8 positions of a
// narrow window took 1.5-2.3x as long a step as four or eight warps
// holding 1 each).
//
// Window build (banded_plan: Wk up to 1280). A block of NT = 128 or
// 256 threads, each owning window positions t = tid + NT r, r < RPT =
// Wk / NT (both templates, so every index is known at compile time).
// Only the real window is computed: a block of rows wholly past the
// diagonal's width (r > 0, NT r >= w[d]) reads nothing and writes -inf
// and code 63 (no source), as the plain version leaves cells past the
// window.
//   The ring: the three newest diagonals in shared memory, each a slot
// of 3 Wk float4 (M, X, Y, unused), so one 16-byte read brings a
// source's three states. Position p of a slot lives at index Wk + p. A
// read offset s is clamped to [-Wk, Wk] (as the plain version clamps
// it), so every read lands in the slot: t + s < 0 is no source and its
// value is unused; t + s >= Wk reads the -inf of indices [2 Wk, 3 Wk),
// never written, and is no source either. A source's validity, the
// window test and i > 0 / j > 0 fold into one range [lo, lo + n) of t
// per source and step, tested per cell with one unsigned compare. Slot
// reuse: diagonal d writes the slot that held d - 3; no thread reads
// d - 3 in step d (its sources are d - 1 and d - 2), and every thread
// has passed step d - 1's barrier, so the last reads of d - 3 (in step
// d - 1) are done. The step table holds each source's slot index with
// its slot (diagonal e in slot e mod 3, worked out a chunk ahead), and
// the slot written advances by one compare a step.
//   The per-position penalties differ from the interior ones only at
// rows 0, 1, L - 1, xbrk, xbrk + 1 and columns 0, 1, R - 1, ybrk,
// ybrk + 1; a step whose window touches none (almost every step) takes
// the interior values without rebuilding them per cell (`fast`).
//   Inputs ahead of the step: the stripe and the schedule rows are
// staged into shared memory with cp.async, TD diagonals a chunk,
// double buffered. When a chunk lands (cp.async.wait_group 0 and a
// barrier, just before its first row is needed), a thread a diagonal
// turns its schedule rows into a step table (source slot indices,
// validity ranges, `fast`), so no step spends its chain on that
// arithmetic. A step first starts its own ring reads (their addresses
// are in registers), then reads the next step's table row and stripe
// values into registers, then computes. The stage buffers a landed
// chunk replaces held the chunk whose last row was read a step
// earlier, before that step's barrier; they are refilled with the
// chunk after next. A landed chunk's step table goes to the table
// buffer of the chunk before the current one, whose last row was read
// before the current chunk's first step, behind at least one barrier;
// the table is read only after the barrier that follows its making.
//   The corner is tested once a step (d == cornerd), a cell only there.
//
// Block build (wider stripes, while the ring of three diagonals and one
// staged diagonal fit in shared memory): one thread a window position
// up to 1024 threads, the three diagonals' M/X/Y as separate rows in
// shared memory, the stripe and schedule staged TD diagonals a chunk,
// one block barrier a step. Global build (past that): the ring in an
// L2-resident global scratch and the stripe read in place.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recently committed group have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// every committed group has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the scalars of one call
struct Scal {
  float gext, gend, gbrk, lgo, lng, olz, orz;
  int L, R, xbrk, ybrk, cornerd, tc;
};

__device__ __forceinline__ Scal load_scal(const float* fscal,
                                          const int* iscal) {
  Scal c;
  c.gext = fscal[0];
  c.gend = fscal[1];
  c.gbrk = fscal[2];
  c.lgo = fscal[3];
  c.lng = fscal[4];
  c.olz = fscal[5];
  c.orz = fscal[6];
  c.L = iscal[0];
  c.R = iscal[1];
  c.xbrk = iscal[2];
  c.ybrk = iscal[3];
  c.cornerd = iscal[4];
  c.tc = iscal[5];
  return c;
}

// ---------------------------------------------------------------------
// Window builds

// One step's uniform values, made from its schedule row when its chunk
// lands (prepare_steps) and read by every thread a step ahead: three
// 16-byte rows of a step table in shared memory.
struct Step {
  int ox, oy, om, wd;        // ring indices of the sources, less t
  int lox, loy, lom, fast;   // t has its X / Y / M source and is in the
  unsigned nx, ny, nm;       //   window: t - lo < n (unsigned); fast:
  int ilo;                   //   interior penalties all over the window
};
constexpr int kStepInts = 12;

// a <= v <= b, for a <= b
__device__ __forceinline__ bool hit(int v, int a, int b) {
  return (unsigned)(v - a) <= (unsigned)(b - a);
}

__device__ __forceinline__ Step make_step(const int* sr, int d, int Wk,
                                          const Scal& c) {
  Step s;
  s.ilo = sr[0];
  s.wd = sr[1];
  const int sx = min(max(sr[2], -Wk), Wk);
  const int sy = min(max(sr[3], -Wk), Wk);
  const int sm = min(max(sr[4], -Wk), Wk);
  s.ox = Wk + sx;
  s.oy = Wk + sy;
  s.om = Wk + sm;
  // t in the window: t < wd; its source in the layout: 0 <= t + s < Wk;
  // i = ilo + t > 0: t >= 1 - ilo; j = d - ilo - t > 0: t < d - ilo
  const int ipos = 1 - s.ilo;
  const int jend = d - s.ilo;
  s.lox = max(max(0, -sx), ipos);
  s.loy = max(0, -sy);
  s.lom = max(max(0, -sm), ipos);
  const int hx = min(s.wd, Wk - sx);
  const int hy = min(min(s.wd, Wk - sy), jend);
  const int hm = min(min(s.wd, Wk - sm), jend);
  s.nx = (unsigned)max(hx - s.lox, 0);
  s.ny = (unsigned)max(hy - s.loy, 0);
  s.nm = (unsigned)max(hm - s.lom, 0);
  // rows i in [a, b], columns j in [d - b, d - a] of the real window
  const int a = s.ilo, b = s.ilo + s.wd - 1;
  const int ca = d - b, cb = d - a;
  const bool special =
      hit(0, a, b) | hit(1, a, b) | hit(c.L - 1, a, b) | hit(c.xbrk, a, b) |
      hit(c.xbrk + 1, a, b) | hit(0, ca, cb) | hit(1, ca, cb) |
      hit(c.R - 1, ca, cb) | hit(c.ybrk, ca, cb) | hit(c.ybrk + 1, ca, cb);
  s.fast = (s.wd <= 0) | !special;
  return s;
}

__device__ __forceinline__ Step load_step(const int* row) {
  const int4 p = *reinterpret_cast<const int4*>(row);
  const int4 q = *reinterpret_cast<const int4*>(row + 4);
  const int4 u = *reinterpret_cast<const int4*>(row + 8);
  Step s;
  s.ox = p.x;
  s.oy = p.y;
  s.om = p.z;
  s.wd = p.w;
  s.lox = q.x;
  s.loy = q.y;
  s.lom = q.z;
  s.fast = q.w;
  s.nx = (unsigned)u.x;
  s.ny = (unsigned)u.y;
  s.nm = (unsigned)u.z;
  s.ilo = u.w;
  return s;
}

// The step table of one landed chunk, rows [k0, k1): a thread a row.
__device__ __forceinline__ void prepare_steps(int* stp, const int* sb,
                                              int k0, int k1, int Wk,
                                              const Scal& c, int tid) {
  if (tid < k1 - k0) {
    const int dd = k0 + tid + 1;
    const Step s = make_step(sb + 8 * tid, dd, Wk, c);
    int4* row = reinterpret_cast<int4*>(stp + kStepInts * tid);
    // slots of d - 1, d - 2 (diagonal e in slot e mod 3; d - 2 >= -1)
    const int s1 = ((dd - 1) % 3) * 3 * Wk, s2 = ((dd + 1) % 3) * 3 * Wk;
    row[0] = make_int4(s.ox + s1, s.oy + s1, s.om + s2, s.wd);
    row[1] = make_int4(s.lox, s.loy, s.lom, s.fast);
    row[2] = make_int4((int)s.nx, (int)s.ny, (int)s.nm, s.ilo);
  }
}

// One cell at window position t: a, b = diagonal d-1's (M, X, Y) at
// t + sx and t + sy, e = diagonal d-2's at t + sm.
template <bool FAST>
__device__ __forceinline__ void window_cell(const float4 a, const float4 b,
                                            const float4 e, float msv,
                                            int t, int d, const Step& s,
                                            const Scal& c, float4& out,
                                            uint32_t& code) {
  const float NEG = -CUDART_INF_F;
  float gj = c.gext, olv = c.lgo, gei = c.gext, orv = c.lgo;
  if (!FAST) {
    const int i = s.ilo + t;
    const int j = d - i;
    gj = (j == c.ybrk) ? c.gbrk : ((j == 0 || j == c.R - 1) ? c.gend
                                                             : c.gext);
    olv = (i - 1 == 0 || i - 1 == c.xbrk) ? c.olz : c.lgo;
    gei = (i == c.xbrk) ? c.gbrk : ((i == 0 || i == c.L - 1) ? c.gend
                                                              : c.gext);
    orv = (j - 1 == 0 || j - 1 == c.ybrk) ? c.orz : c.lgo;
  }
  // X: gap consuming left site i (ext, double, open)
  const float cx0 = a.y + gj;
  const float cx1 = a.z + c.lgo;
  const float cx2 = (a.x + c.lng) + olv;
  const float v01 = fmaxf(cx0, cx1);
  const float xc = fmaxf(v01, cx2);
  const uint32_t bx = (cx2 > v01) ? 8u : ((cx1 > cx0) ? 4u : 0u);
  // Y: gap consuming right site j (ext, double, open)
  const float cy0 = b.z + gei;
  const float cy1 = b.y + c.lgo;
  const float cy2 = (b.x + c.lng) + orv;
  const float w01 = fmaxf(cy0, cy1);
  const float yc = fmaxf(w01, cy2);
  const uint32_t by = (cy2 > w01) ? 32u : ((cy1 > cy0) ? 16u : 0u);
  // M: match consuming both (m, x, y)
  const float t2 = e.x + c.lng;
  const float u01 = fmaxf(t2, e.y);
  const float mc = fmaxf(u01, e.z);
  const uint32_t bm = (e.z > u01) ? 2u : ((e.y > t2) ? 1u : 0u);
  const bool okx = (unsigned)(t - s.lox) < s.nx;
  const bool oky = (unsigned)(t - s.loy) < s.ny;
  const bool okm = (unsigned)(t - s.lom) < s.nm;
  out = make_float4(okm ? mc + msv : NEG, okx ? xc : NEG, oky ? yc : NEG,
                    NEG);
  code = (okm ? bm : 3u) | (okx ? bx : 12u) | (oky ? by : 48u);
}

// Stage stripe rows [k0, k1) and schedule rows [k0, k1) into stage
// buffer `buf`, 16 bytes a copy.
__device__ __forceinline__ void stage_window(float* mst, int* sst,
                                             const float* ms,
                                             const int* sched, int k0,
                                             int k1, int Wk, int TD,
                                             int buf, int nt, int tid) {
  float* mb = mst + (size_t)buf * TD * Wk;
  int* sb = sst + buf * TD * 8;
  const int nq = Wk >> 2;
  int kr = 0, q = tid;
  while (q >= nq) {
    q -= nq;
    ++kr;
  }
  for (; kr < k1 - k0;) {
    cp_async16(mb + kr * Wk + 4 * q, ms + (size_t)(k0 + kr) * Wk + 4 * q);
    q += nt;
    while (q >= nq) {
      q -= nq;
      ++kr;
    }
  }
  const int pieces = 2 * (k1 - k0);  // 32-byte rows, 16 bytes a copy
  for (int p = tid; p < pieces; p += nt)
    cp_async16(sb + 4 * p, sched + (size_t)k0 * 8 + 4 * p);
}

template <int RPT, int NT>
__global__ void __launch_bounds__(NT, 1)
    viterbi_banded_window_kernel(const float* __restrict__ fscal,
                                 const int* __restrict__ iscal,
                                 const int* __restrict__ sched,
                                 const float* __restrict__ ms,
                                 uint8_t* __restrict__ codes,
                                 float* __restrict__ corner, int Dn,
                                 int TD) {
  constexpr int Wk = NT * RPT;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  float4* ring = reinterpret_cast<float4*>(smem);        // [3][3 Wk]
  float* mst = smem + 4 * 9 * Wk;                         // [2][TD][Wk]
  int* sst = reinterpret_cast<int*>(mst + 2 * TD * Wk);    // [2][TD][8]
  int* stp = sst + 2 * TD * 8;                             // [2][TD][12]
  const Scal c = load_scal(fscal, iscal);
  const float NEG = -CUDART_INF_F;
  const float4 NEG4 = make_float4(NEG, NEG, NEG, NEG);

  // diagonal 0 (slot 0): M(0, 0) = 0, all else -inf; diagonal -1 (slot
  // 2) and slot 1 all -inf
  for (int x = tid; x < 9 * Wk; x += NT)
    ring[x] = (x == Wk) ? make_float4(0.0f, NEG, NEG, NEG) : NEG4;
  if (tid == 0) {
    corner[0] = NEG;
    corner[1] = NEG;
    corner[2] = NEG;
  }
  stage_window(mst, sst, ms, sched, 0, min(TD, Dn), Wk, TD, 0, NT, tid);
  cp_async_commit();
  if (TD < Dn)
    stage_window(mst, sst, ms, sched, TD, min(2 * TD, Dn), Wk, TD, 1, NT,
                 tid);
  cp_async_commit();
  cp_async_wait_prior();
  __syncthreads();   // every thread's copies of chunk 0 landed
  prepare_steps(stp, sst, 0, min(TD, Dn), Wk, c, tid);
  __syncthreads();   // the ring and chunk 0's step table

  Step nxt = load_step(stp);
  float msn[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) msn[r] = mst[tid + NT * r];
  float4* g0 = ring + 3 * Wk;   // the slot of diagonal d
  uint8_t* crow = codes + tid;
  int kk = 1, buf = 0;   // chunk row and buffer of step k + 1

  for (int k = 0; k < Dn; ++k) {
    const int d = k + 1;
    const Step s = nxt;
    float mv[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) mv[r] = msn[r];
    // this step's sources first: nothing else waits on the barrier. A
    // block of rows wholly past the window (r > 0, NT r >= w[d]) reads
    // nothing.
    float4 A[RPT], B[RPT], E[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int t = tid + NT * r;
      if (r == 0 || NT * r < s.wd) {
        A[r] = ring[t + s.ox];
        B[r] = ring[t + s.oy];
        E[r] = ring[t + s.om];
      } else {
        A[r] = B[r] = E[r] = NEG4;
      }
    }
    // then the next step's inputs, while those reads are in flight
    if (k + 1 < Dn) {
      if (kk == TD) {
        // step k + 1 opens the next chunk: wait for it and make its step
        // table; the buffers of step k's chunk (last read a step ago)
        // take the chunk after next
        cp_async_wait_all();
        __syncthreads();
        buf ^= 1;
        kk = 0;
        prepare_steps(stp + buf * TD * kStepInts, sst + buf * TD * 8, k + 1,
                      min(k + 1 + TD, Dn), Wk, c, tid);
        const int n0 = k + 1 + TD;
        if (n0 < Dn)
          stage_window(mst, sst, ms, sched, n0, min(n0 + TD, Dn), Wk, TD,
                       buf ^ 1, NT, tid);
        cp_async_commit();
        __syncthreads();
      }
      nxt = load_step(stp + (buf * TD + kk) * kStepInts);
      const float* mrow = mst + (size_t)(buf * TD + kk) * Wk + tid;
#pragma unroll
      for (int r = 0; r < RPT; ++r) msn[r] = mrow[NT * r];
      ++kk;
    }

    float4 out[RPT];
    uint32_t code[RPT];
    if (s.fast) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (r == 0 || NT * r < s.wd) {
          window_cell<true>(A[r], B[r], E[r], mv[r], tid + NT * r, d, s, c,
                            out[r], code[r]);
        } else {
          out[r] = NEG4;   // past the window: -inf, no source
          code[r] = 63u;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (r == 0 || NT * r < s.wd) {
          window_cell<false>(A[r], B[r], E[r], mv[r], tid + NT * r, d, s,
                             c, out[r], code[r]);
        } else {
          out[r] = NEG4;
          code[r] = 63u;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      g0[Wk + tid + NT * r] = out[r];
      crow[NT * r] = (uint8_t)code[r];
    }
    if (d == c.cornerd) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (tid + NT * r == c.tc) {
          corner[0] = out[r].x;
          corner[1] = out[r].y;
          corner[2] = out[r].z;
        }
      }
    }
    crow += Wk;
    g0 = (g0 == ring + 6 * Wk) ? ring : g0 + 3 * Wk;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// Block and global builds

// Stage stripe rows [k0, k1) and schedule rows [k0, k1) into stage
// buffer `buf`, 16 bytes a copy.
__device__ __forceinline__ void stage_rows(float* mst, int* sst,
                                           const float* ms,
                                           const int* sched, int k0,
                                           int k1, int Wk, int TD,
                                           int buf, int nq, int nt) {
  float* mb = mst + (size_t)buf * TD * Wk;
  int* sb = sst + buf * TD * 8;
  for (int k = k0; k < k1; ++k) {
    const float* src = ms + (size_t)k * Wk;
    float* dst = mb + (size_t)(k - k0) * Wk;
    for (int q = threadIdx.x; q < nq; q += nt)
      cp_async16(dst + 4 * q, src + 4 * q);
  }
  const int pieces = 2 * (k1 - k0);  // 32-byte rows, 16 bytes a copy
  for (int p = threadIdx.x; p < pieces; p += nt)
    cp_async16(sb + 4 * p, sched + (size_t)k0 * 8 + 4 * p);
}

// STAGED: the ring and the staged rows in shared memory; else the ring
// in the global scratch gbuf and the stripe and schedule read in place.
template <bool STAGED>
__global__ void __launch_bounds__(1024) viterbi_banded_block_kernel(
    const float* __restrict__ fscal,   // (8): gext gend gbrk lgo lng olz orz
    const int* __restrict__ iscal,     // (8): L R xbrk ybrk cornerd tc
    const int* __restrict__ sched,     // (Dn, 8): ilo w sx sy sm
    const float* __restrict__ ms,      // (Dn, Wk) folded, row d-1 = diag d
    uint8_t* __restrict__ codes,       // (Dn, Wk)
    float* __restrict__ corner,        // (3)
    float* gbuf,                       // (9 * Wk) when not STAGED
    int Dn, int Wk, int TD) {
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x;
  const int nq = Wk >> 2;
  // ring: [diagonal slot 0..2][M, X, Y][Wk]; diagonal d in slot d % 3
  float* ring = STAGED ? smem : gbuf;
  float* mst = smem + 9 * Wk;                                // [2][TD][Wk]
  int* sst = reinterpret_cast<int*>(mst + 2 * TD * Wk);      // [2][TD][8]
  const float NEG = -CUDART_INF_F;
  const Scal c = load_scal(fscal, iscal);

  // diagonal 0 (slot 0): M(0, 0) = 0, all else -inf; diagonal -1
  // (slot 2) all -inf
  for (int x = threadIdx.x; x < 9 * Wk; x += nt)
    ring[x] = (x == 0) ? 0.0f : NEG;
  if (threadIdx.x == 0) {
    corner[0] = NEG;
    corner[1] = NEG;
    corner[2] = NEG;
  }
  if (STAGED) {
    stage_rows(mst, sst, ms, sched, 0, min(TD, Dn), Wk, TD, 0, nq, nt);
    cp_async_commit();
  }
  __syncthreads();

  const int step = STAGED ? TD : Dn;
  int chunk = 0;
  for (int c0 = 0; c0 < Dn; c0 += step, ++chunk) {
    const int c1 = min(c0 + step, Dn);
    const int buf = chunk & 1;
    if (STAGED) {
      // the other buffer was last read by the previous chunk, which
      // ended in a step barrier
      if (c1 < Dn)
        stage_rows(mst, sst, ms, sched, c1, min(c1 + TD, Dn), Wk, TD,
                   buf ^ 1, nq, nt);
      cp_async_commit();
      cp_async_wait_prior();
      __syncthreads();   // every thread's copies of this chunk landed
    }
    for (int k = c0; k < c1; ++k) {
      const int d = k + 1;
      const int* sr = STAGED ? sst + (buf * TD + (k - c0)) * 8
                             : sched + (size_t)k * 8;
      const int ilo_d = sr[0];
      const int wd = sr[1];
      const int sx = sr[2];
      const int sy = sr[3];
      const int sm = sr[4];
      const float* g1 = ring + ((d + 2) % 3) * 3 * Wk;   // diagonal d-1
      const float* g2 = ring + ((d + 1) % 3) * 3 * Wk;   // diagonal d-2
      float* g0 = ring + (d % 3) * 3 * Wk;               // diagonal d
      const float* msd = STAGED ? mst + (size_t)(buf * TD + (k - c0)) * Wk
                                : ms + (size_t)k * Wk;
      for (int t = threadIdx.x; t < Wk; t += nt) {
        // sources: X (i-1, j) and Y (i, j-1) on diagonal d-1, M
        // (i-1, j-1) on diagonal d-2; -inf outside the layout
        const int px = t + sx;
        const int py = t + sy;
        const int pm = t + sm;
        const bool vx = px >= 0 && px < Wk;
        const bool vy = py >= 0 && py < Wk;
        const bool vm = pm >= 0 && pm < Wk;
        const float m1 = vx ? g1[px] : NEG;
        const float x1 = vx ? g1[Wk + px] : NEG;
        const float y1 = vx ? g1[2 * Wk + px] : NEG;
        const float m1y = vy ? g1[py] : NEG;
        const float x1y = vy ? g1[Wk + py] : NEG;
        const float y1y = vy ? g1[2 * Wk + py] : NEG;
        const float m2 = vm ? g2[pm] : NEG;
        const float x2 = vm ? g2[Wk + pm] : NEG;
        const float y2 = vm ? g2[2 * Wk + pm] : NEG;
        const float msv = msd[t];
        const int i = ilo_d + t;
        const int j = d - i;
        const bool okw = t < wd;
        // X: gap consuming left site i (ext, double, open)
        const float gj = (j == c.ybrk) ? c.gbrk
                         : ((j == 0 || j == c.R - 1) ? c.gend : c.gext);
        const float olv = (i - 1 == 0 || i - 1 == c.xbrk) ? c.olz : c.lgo;
        const float cx0 = x1 + gj;
        const float cx1 = y1 + c.lgo;
        const float cx2 = (m1 + c.lng) + olv;
        const float v01 = fmaxf(cx0, cx1);
        const float xc = fmaxf(v01, cx2);
        const uint32_t bx = (cx2 > v01) ? 2u : ((cx1 > cx0) ? 1u : 0u);
        // Y: gap consuming right site j (ext, double, open)
        const float gei = (i == c.xbrk) ? c.gbrk
                          : ((i == 0 || i == c.L - 1) ? c.gend : c.gext);
        const float orv = (j - 1 == 0 || j - 1 == c.ybrk) ? c.orz : c.lgo;
        const float cy0 = y1y + gei;
        const float cy1 = x1y + c.lgo;
        const float cy2 = (m1y + c.lng) + orv;
        const float w01 = fmaxf(cy0, cy1);
        const float yc = fmaxf(w01, cy2);
        const uint32_t by = (cy2 > w01) ? 2u : ((cy1 > cy0) ? 1u : 0u);
        // M: match consuming both (m, x, y)
        const float t2 = m2 + c.lng;
        const float u01 = fmaxf(t2, x2);
        const float mc = fmaxf(u01, y2);
        const uint32_t bm = (y2 > u01) ? 2u : ((x2 > t2) ? 1u : 0u);
        const bool okx = okw && i > 0 && vx;
        const bool oky = okw && j > 0 && vy;
        const bool okm = okw && i > 0 && j > 0 && vm;
        const float X = okx ? xc : NEG;
        const float Y = oky ? yc : NEG;
        const float M = okm ? mc + msv : NEG;
        g0[t] = M;
        g0[Wk + t] = X;
        g0[2 * Wk + t] = Y;
        codes[(size_t)k * Wk + t] = (uint8_t)((okm ? bm : 3u) |
                                              ((okx ? bx : 3u) << 2) |
                                              ((oky ? by : 3u) << 4));
        if (d == c.cornerd && t == c.tc) {
          corner[0] = M;
          corner[1] = X;
          corner[2] = Y;
        }
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------
// Launch

enum Build { kWindow = 0, kBlock = 1, kGlobal = 2 };

struct Args {
  const float* fscal;
  const int* iscal;
  const int* sched;
  const float* ms;
  uint8_t* codes;
  float* corner;
  int Dn, td;
};

template <typename K>
int opt_in(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not left to be blamed on the next launch
    return (int)err;
  }
  return 0;
}

template <int RPT, int NT>
int launch_window(const Args& a, size_t smem, cudaStream_t st) {
  auto kern = viterbi_banded_window_kernel<RPT, NT>;
  if (int err = opt_in(kern, smem)) return err;
  kern<<<1, NT, smem, st>>>(a.fscal, a.iscal, a.sched, a.ms, a.codes,
                            a.corner, a.Dn, a.td);
  return (int)cudaGetLastError();
}

// the window builds banded_plan uses: 256 threads on a stripe of whole
// 256-column groups up to 1280, else 128 threads up to 896
int dispatch_window(const Args& a, int threads, int rpt, size_t smem,
                    cudaStream_t st) {
  if (threads == 128) {
    switch (rpt) {
      case 1: return launch_window<1, 128>(a, smem, st);
      case 3: return launch_window<3, 128>(a, smem, st);
      case 5: return launch_window<5, 128>(a, smem, st);
      case 7: return launch_window<7, 128>(a, smem, st);
    }
  } else if (threads == 256) {
    switch (rpt) {
      case 1: return launch_window<1, 256>(a, smem, st);
      case 2: return launch_window<2, 256>(a, smem, st);
      case 3: return launch_window<3, 256>(a, smem, st);
      case 4: return launch_window<4, 256>(a, smem, st);
      case 5: return launch_window<5, 256>(a, smem, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const size_t kMaxShared = 232448;

}  // namespace

// The launch plan, as viterbi_banded.py::banded_plan computes it:
// build 0 (window): `threads` x rpt = Wk window positions, td diagonals
// a staged chunk (1-32: a thread a diagonal makes the chunk's step
// table), smem = 144 Wk + 2 td (4 Wk + 80) bytes; build 1 (block): one
// position a thread in a loop over [0, Wk), td diagonals a chunk, smem
// = 36 Wk + 2 td (4 Wk + 32); build 2 (global): the ring in gbuf (9 Wk
// floats), td 0, smem 0. Any other plan is refused
// (cudaErrorInvalidValue).
extern "C" int viterbi_banded_launch(const void* fscal, const void* iscal,
                                     const void* sched, const void* ms,
                                     void* codes, void* corner, void* gbuf,
                                     int Dn, int Wk, int build, int threads,
                                     int rpt, int td, int smem,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Args a{(const float*)fscal, (const int*)iscal, (const int*)sched,
         (const float*)ms,    (uint8_t*)codes,   (float*)corner,
         Dn,                  td};
  const size_t sm = (size_t)smem;
  if (Dn < 1 || Wk < 128 || Wk % 128 || smem < 0 || sm > kMaxShared)
    return (int)cudaErrorInvalidValue;
  if (build == kWindow) {
    if (threads * rpt != Wk || td < 1 || td > 32 ||
        sm != (size_t)144 * Wk + (size_t)2 * td * (4 * Wk + 80))
      return (int)cudaErrorInvalidValue;
    return dispatch_window(a, threads, rpt, sm, st);
  }
  if (build == kBlock) {
    if (threads != min(1024, Wk) || td < 1 ||
        sm != (size_t)36 * Wk + (size_t)2 * td * ((size_t)4 * Wk + 32))
      return (int)cudaErrorInvalidValue;
    auto kern = viterbi_banded_block_kernel<true>;
    if (int err = opt_in(kern, sm)) return err;
    kern<<<1, threads, sm, st>>>(a.fscal, a.iscal, a.sched, a.ms, a.codes,
                                 a.corner, nullptr, Dn, Wk, td);
    return (int)cudaGetLastError();
  }
  if (build == kGlobal) {
    if (threads != min(1024, Wk) || td != 0 || smem != 0 ||
        gbuf == nullptr)
      return (int)cudaErrorInvalidValue;
    viterbi_banded_block_kernel<false><<<1, threads, 0, st>>>(
        a.fscal, a.iscal, a.sched, a.ms, a.codes, a.corner, (float*)gbuf,
        Dn, Wk, 0);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
