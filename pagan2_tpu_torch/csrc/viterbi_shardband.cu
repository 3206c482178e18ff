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
// Inside a launch the same idea tiles the shard: CUDA block b loads
// local lanes [b*TT, b*TT + H + TT) from the carry (TT = blockDim - H)
// and owns the last TT of them, so no block waits for another and a
// diagonal costs one __syncthreads: the wavefront of the last three
// diagonals (G: M, X, Y) or the ring of the last G + 1 (H: M, X, Y) sits
// in shared memory, written at the slot of diagonal d while the others
// are read.
//
// Recurrences and codes are the reference's scan cores, bit for bit:
//  G (batched_sheared_core): X from (i-1, j): ext x + gj[j], double
//    y + lgo, open (m + lng) + olp[i]; Y from (i, j-1): ext y + gexti[i],
//    double x + lgo, open (m + lng) + orp[j]; M from (i-1, j-1):
//    (m + lng) + wadd, x + wadd, y + wadd with
//    wadd = ((lng + ms) + lw[i]) + rw[j] (compared after the add);
//    first wins on a tie; codes bm | bx << 2 | by << 4, 3 where masked.
//  H (_build_core_onehot): per left edge slot kk (offset o) X's ext,
//    double, open; per right slot Y's; per (kl, kr) pair M's m, x, y;
//    strict-greater first-wins over the reference's order; codes
//    bm | bx << 16 | by << 24 with 65535 / 255 / 255 where masked.
// Only additions, maxima and selects: no multiply, so nvcc contracts
// nothing and the f32 results equal the plain versions'.
//
// What bounds them on an H100: neither bytes nor operations (a cell
// reads its match score and writes one code) but the chain of
// dependent diagonals, one barrier each, and the launch of each block of
// H diagonals with its halo exchange between launches.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEGF (-INFINITY)

// ------------------------------------------------------------------
// kernel G
__global__ void shardband_linear_kernel(
    const float* __restrict__ cin, float* __restrict__ cout,
    uint8_t* __restrict__ codes, float* __restrict__ corner,
    const float* __restrict__ ms, const float* __restrict__ gexti,
    const float* __restrict__ olp, const float* __restrict__ lw,
    const int* __restrict__ vlo, const int* __restrict__ vhi,
    const float* __restrict__ gj, const float* __restrict__ orp,
    const float* __restrict__ rw, float lng, float lgo, int L, int R,
    int base, int H, int d0, int nsteps, int wloc) {
  extern __shared__ float sh[];        // [3 diagonals][M, X, Y][nt]
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int li = blockIdx.x * (nt - H) + tid;    // local lane
  const int w = wloc - H;
  const bool live = li < wloc;
  const bool owned = live && tid >= H;
  const int ii = base + li;                       // global row

  float m1 = NEGF, x1 = NEGF, y1 = NEGF, m2 = NEGF, x2 = NEGF, y2 = NEGF;
  float gi = 0.f, ol = 0.f, lwi = 0.f;
  int blo = 1, bhi = 0;
  if (live) {
    m1 = cin[li];
    x1 = cin[wloc + li];
    y1 = cin[2 * wloc + li];
    m2 = cin[3 * wloc + li];
    x2 = cin[4 * wloc + li];
    y2 = cin[5 * wloc + li];
    gi = gexti[li];
    ol = olp[li];
    lwi = lw[li];
    blo = vlo[li];
    bhi = vhi[li];
  }
  const float* msrow = ms + (size_t)(live ? li : 0) * R;
  // the slot of diagonal e (e >= d0 - 2 >= -1)
#define GSLOT(e) (((e) + 3) % 3)
  float* s1 = sh + GSLOT(d0 - 1) * 3 * nt;
  float* s2 = sh + GSLOT(d0 - 2) * 3 * nt;
  s1[tid] = m1; s1[nt + tid] = x1; s1[2 * nt + tid] = y1;
  s2[tid] = m2; s2[nt + tid] = x2; s2[2 * nt + tid] = y2;
  __syncthreads();

  const int last = L + R - 2;
  for (int t = 0; t < nsteps; ++t) {
    const int d = d0 + t;
    const float* p1 = sh + GSLOT(d - 1) * 3 * nt;
    const float* p2 = sh + GSLOT(d - 2) * 3 * nt;
    float m1s = NEGF, x1s = NEGF, y1s = NEGF;
    float m2s = NEGF, x2s = NEGF, y2s = NEGF;
    if (tid > 0) {
      m1s = p1[tid - 1]; x1s = p1[nt + tid - 1]; y1s = p1[2 * nt + tid - 1];
      m2s = p2[tid - 1]; x2s = p2[nt + tid - 1]; y2s = p2[2 * nt + tid - 1];
    }
    const int j = d - ii;
    const bool inr = j >= 0 && j < R;
    const bool valid = live && inr && ii < L && j >= blo && j <= bhi;
    const float gjv = inr ? gj[j] : 0.f;
    const float orv = inr ? orp[j] : 0.f;
    const float rwv = inr ? rw[j] : 0.f;
    const float msv = valid ? msrow[j] : 0.f;

    float c0 = x1s + gjv, c1 = y1s + lgo, c2 = (m1s + lng) + ol;
    float vx = c0;
    int bx = 0;
    if (c1 > vx) { vx = c1; bx = 1; }
    if (c2 > vx) { vx = c2; bx = 2; }
    const bool okx = valid && ii > 0 && isfinite(vx);

    c0 = y1 + gi; c1 = x1 + lgo; c2 = (m1 + lng) + orv;
    float vy = c0;
    int by = 0;
    if (c1 > vy) { vy = c1; by = 1; }
    if (c2 > vy) { vy = c2; by = 2; }
    const bool oky = valid && j > 0 && isfinite(vy);

    const float wadd = ((lng + msv) + lwi) + rwv;
    c0 = (m2s + lng) + wadd; c1 = x2s + wadd; c2 = y2s + wadd;
    float vm = c0;
    int bm = 0;
    if (c1 > vm) { vm = c1; bm = 1; }
    if (c2 > vm) { vm = c2; bm = 2; }
    const bool okm = valid && ii > 0 && j > 0 && isfinite(vm);

    const float X = okx ? vx : NEGF;
    const float Y = oky ? vy : NEGF;
    const float M = okm ? vm : NEGF;
    if (owned) {
      codes[(size_t)d * w + (li - H)] = (uint8_t)(
          (okm ? bm : 3) | ((okx ? bx : 3) << 2) | ((oky ? by : 3) << 4));
      if (d == last && ii == L - 1) {
        corner[0] = M; corner[1] = X; corner[2] = Y;
      }
    }
    m2 = m1; x2 = x1; y2 = y1;
    m1 = M; x1 = X; y1 = Y;
    float* s0 = sh + GSLOT(d) * 3 * nt;
    s0[tid] = M; s0[nt + tid] = X; s0[2 * nt + tid] = Y;
    __syncthreads();
  }
#undef GSLOT
  if (owned) {
    cout[li] = m1; cout[wloc + li] = x1; cout[2 * wloc + li] = y1;
    cout[3 * wloc + li] = m2; cout[4 * wloc + li] = x2;
    cout[5 * wloc + li] = y2;
  }
}

extern "C" int shardband_linear_launch(
    const void* cin, void* cout, void* codes, void* corner, const void* ms,
    const void* gexti, const void* olp, const void* lw, const void* vlo,
    const void* vhi, const void* gj, const void* orp, const void* rw,
    float lng, float lgo, int L, int R, int base, int H, int d0, int nsteps,
    int wloc, int threads, int smem, void* stream) {
  if (threads < 32 || threads > 1024 || H < 1 || H >= threads)
    return (int)cudaErrorInvalidValue;
  const int tile = threads - H;
  const int w = wloc - H;
  const int blocks = (w + tile - 1) / tile;
  shardband_linear_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)cin, (float*)cout, (uint8_t*)codes, (float*)corner,
      (const float*)ms, (const float*)gexti, (const float*)olp,
      (const float*)lw, (const int*)vlo, (const int*)vhi, (const float*)gj,
      (const float*)orp, (const float*)rw, lng, lgo, L, R, base, H, d0,
      nsteps, wloc);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------
// kernel H
__global__ void shardband_fanin_kernel(
    const float* __restrict__ cin, float* __restrict__ cout,
    int32_t* __restrict__ codes, float* __restrict__ snap,
    const int* __restrict__ lstate, const float* __restrict__ table,
    const int* __restrict__ loff, const float* __restrict__ llw,
    const float* __restrict__ lopen, const float* __restrict__ gexti,
    const int* __restrict__ vlo, const int* __restrict__ vhi,
    const int* __restrict__ rstate, const float* __restrict__ gextj,
    const int* __restrict__ roff, const float* __restrict__ rlw,
    const float* __restrict__ ropen, float lng, float lgo, int L, int R,
    int base, int H, int d0, int nsteps, int wloc, int G, int KL, int KR,
    int nf) {
  extern __shared__ float ring[];      // [M, X, Y][G + 1 slots][nt]
  const int nt = blockDim.x;
  const int GR = G + 1;
  const int tid = threadIdx.x;
  const int li = blockIdx.x * (nt - H) + tid;
  const int w = wloc - H;
  const bool live = li < wloc;
  const bool owned = live && tid >= H;
  const int ii = base + li;
  // the slot of diagonal e (e >= d0 - G > -GR)
#define HSLOT(e) (((e) + GR) % GR)
#define RING(m, e, lane) ring[((m) * GR + HSLOT(e)) * nt + (lane)]

  for (int g = 0; g < G; ++g)
    for (int m = 0; m < 3; ++m)
      RING(m, d0 - 1 - g, tid) =
          live ? cin[((size_t)m * G + g) * wloc + li] : NEGF;
  float gi = 0.f;
  int blo = 1, bhi = 0, ls = 0;
  if (live) {
    gi = gexti[li];
    blo = vlo[li];
    bhi = vhi[li];
    ls = lstate[li];
  }
  const int lrow = live ? li : 0;
  __syncthreads();

  const int last = L + R - 2;
  for (int t = 0; t < nsteps; ++t) {
    const int d = d0 + t;
    const int jj = d - ii;
    const bool inr = jj >= 0 && jj < R;
    const int jc = inr ? jj : 0;
    const bool valid = live && inr && ii >= 0 && ii < L && jj >= blo &&
                       jj <= bhi;
    const int rs = inr ? rstate[jc] : nf - 1;
    const float msv = table[ls * nf + rs];
    const float gjx = inr ? gextj[jc] : 0.f;

    // ---- X: gap consuming left site i, per left edge slot ----
    float bestX = NEGF;
    int codeX = 255;
    for (int kk = 0; kk < KL; ++kk) {
      const int o = loff[lrow * KL + kk];
      float vM = NEGF, vX = NEGF, vY = NEGF;
      if (o >= 1 && o <= G && tid - o >= 0) {
        vM = RING(0, d - o, tid - o);
        vX = RING(1, d - o, tid - o);
        vY = RING(2, d - o, tid - o);
      }
      float c = vX + gjx;
      if (c > bestX) { bestX = c; codeX = kk * 3; }
      c = vY + lgo;
      if (c > bestX) { bestX = c; codeX = kk * 3 + 1; }
      c = (vM + lng) + lopen[lrow * KL + kk];
      if (c > bestX) { bestX = c; codeX = kk * 3 + 2; }
    }
    // ---- Y: gap consuming right site j, per right edge slot ----
    float bestY = NEGF;
    int codeY = 255;
    for (int kk = 0; kk < KR; ++kk) {
      const int o = inr ? roff[jc * KR + kk] : 0;
      float vM = NEGF, vX = NEGF, vY = NEGF;
      if (o >= 1 && o <= G) {
        vM = RING(0, d - o, tid);
        vX = RING(1, d - o, tid);
        vY = RING(2, d - o, tid);
      }
      float c = vY + gi;
      if (c > bestY) { bestY = c; codeY = kk * 3; }
      c = vX + lgo;
      if (c > bestY) { bestY = c; codeY = kk * 3 + 1; }
      c = (vM + lng) + (inr ? ropen[jc * KR + kk] : 0.f);
      if (c > bestY) { bestY = c; codeY = kk * 3 + 2; }
    }
    // ---- M: match consuming both, left slot outer, right inner ----
    float bestM = NEGF;
    int codeM = 65535;
    const float mbase = lng + msv;
    for (int kl = 0; kl < KL; ++kl) {
      const int s = loff[lrow * KL + kl];
      const float lwb = mbase + llw[lrow * KL + kl];
      for (int kr = 0; kr < KR; ++kr) {
        const int r = inr ? roff[jc * KR + kr] : 0;
        float vM = NEGF, vX = NEGF, vY = NEGF;
        if (s >= 1 && r >= 1 && s + r <= G && tid - s >= 0) {
          vM = RING(0, d - s - r, tid - s);
          vX = RING(1, d - s - r, tid - s);
          vY = RING(2, d - s - r, tid - s);
        }
        const float b = lwb + (inr ? rlw[jc * KR + kr] : 0.f);
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
    float M = okm ? bestM : NEGF;
    if (ii == 0 && jj == 0) M = 0.f;
    const float X = okx ? bestX : NEGF;
    const float Y = oky ? bestY : NEGF;
    if (owned)
      codes[(size_t)d * w + (li - H)] = (int32_t)(
          (uint32_t)(okm ? codeM : 65535) +
          ((uint32_t)(okx ? codeX : 255) << 16) +
          ((uint32_t)(oky ? codeY : 255) << 24));
    RING(0, d, tid) = M;
    RING(1, d, tid) = X;
    RING(2, d, tid) = Y;
    if (owned && d == last)
      for (int g = 0; g < G; ++g)
        for (int m = 0; m < 3; ++m)
          snap[((size_t)m * G + g) * w + (li - H)] = RING(m, d - g, tid);
    __syncthreads();
  }
  if (owned) {
    const int dl = d0 + nsteps - 1;
    for (int g = 0; g < G; ++g)
      for (int m = 0; m < 3; ++m)
        cout[((size_t)m * G + g) * wloc + li] = RING(m, dl - g, tid);
  }
#undef RING
#undef HSLOT
}

extern "C" int shardband_fanin_launch(
    const void* cin, void* cout, void* codes, void* snap, const void* lstate,
    const void* table, const void* loff, const void* llw, const void* lopen,
    const void* gexti, const void* vlo, const void* vhi, const void* rstate,
    const void* gextj, const void* roff, const void* rlw, const void* ropen,
    float lng, float lgo, int L, int R, int base, int H, int d0, int nsteps,
    int wloc, int G, int KL, int KR, int nf, int threads, int smem,
    void* stream) {
  if (threads < 32 || threads > 1024 || H < 1 || H >= threads || G < 1 ||
      smem != 12 * (G + 1) * threads)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      shardband_fanin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int tile = threads - H;
  const int w = wloc - H;
  const int blocks = (w + tile - 1) / tile;
  shardband_fanin_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)cin, (float*)cout, (int32_t*)codes, (float*)snap,
      (const int*)lstate, (const float*)table, (const int*)loff,
      (const float*)llw, (const float*)lopen, (const float*)gexti,
      (const int*)vlo, (const int*)vhi, (const int*)rstate,
      (const float*)gextj, (const int*)roff, (const float*)rlw,
      (const float*)ropen, lng, lgo, L, R, base, H, d0, nsteps, wloc, G, KL,
      KR, nf);
  return (int)cudaGetLastError();
}
