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
// source outside [0, Wk) reads -inf and its code is 3 ("none"). Codes
// are plain bytes at the TARGET cell (bm bits 0-1, bx 2-3, by 4-5), so
// the Pallas kernel's packed f32 words and source-position codes do not
// exist here.
//
// What bounds it on an H100: not bytes (5 B per window cell against
// 3.35 TB/s) and not operations (~30 f32 add/compare/select per cell
// against 67 TFLOP/s), but the serial chain of D - 1 dependent
// diagonals of one pair (2.1 M for a 1 Mb pair), each a few hundred
// cells wide at most, with one block on 132 SMs.
//
// What the design does about it: each step is kept as short as the
// chain allows. One block per pair; each thread owns one window row,
// so a window of up to 128 rows is 4 warps, one on each of the SM's
// four schedulers, and a thread's step is one cell's short chain. M/X/Y
// of the last three diagonals (36 * Wk bytes) stay in shared memory, so
// a step reads its sources and writes its cells on chip and ends in one
// barrier. The stripe and schedule rows are
// staged into shared memory with cp.async, TD diagonals at a time and
// one chunk ahead (double buffered), so no step waits on device memory.
// A window too wide for that budget keeps the three diagonals in an
// L2-resident global scratch and reads the stripe in place.
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
__global__ void __launch_bounds__(1024) viterbi_banded_kernel(
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
  const float gext = fscal[0];
  const float gend = fscal[1];
  const float gbrk = fscal[2];
  const float lgo = fscal[3];
  const float lng = fscal[4];
  const float olz = fscal[5];
  const float orz = fscal[6];
  const int R = iscal[1];
  const int L = iscal[0];
  const int xbrk = iscal[2];
  const int ybrk = iscal[3];
  const int cornerd = iscal[4];
  const int tc = iscal[5];

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
        const float gj = (j == ybrk) ? gbrk
                         : ((j == 0 || j == R - 1) ? gend : gext);
        const float olv = (i - 1 == 0 || i - 1 == xbrk) ? olz : lgo;
        const float cx0 = x1 + gj;
        const float cx1 = y1 + lgo;
        const float cx2 = (m1 + lng) + olv;
        const float v01 = fmaxf(cx0, cx1);
        const float xc = fmaxf(v01, cx2);
        const uint32_t bx = (cx2 > v01) ? 2u : ((cx1 > cx0) ? 1u : 0u);
        // Y: gap consuming right site j (ext, double, open)
        const float gei = (i == xbrk) ? gbrk
                          : ((i == 0 || i == L - 1) ? gend : gext);
        const float orv = (j - 1 == 0 || j - 1 == ybrk) ? orz : lgo;
        const float cy0 = y1y + gei;
        const float cy1 = x1y + lgo;
        const float cy2 = (m1y + lng) + orv;
        const float w01 = fmaxf(cy0, cy1);
        const float yc = fmaxf(w01, cy2);
        const uint32_t by = (cy2 > w01) ? 2u : ((cy1 > cy0) ? 1u : 0u);
        // M: match consuming both (m, x, y)
        const float t2 = m2 + lng;
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
        if (d == cornerd && t == tc) {
          corner[0] = M;
          corner[1] = X;
          corner[2] = Y;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int viterbi_banded_launch(const void* fscal, const void* iscal,
                                     const void* sched, const void* ms,
                                     void* codes, void* corner, void* gbuf,
                                     int Dn, int Wk, int td, int threads,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (td == 0) {
    viterbi_banded_kernel<false><<<1, threads, 0, st>>>(
        (const float*)fscal, (const int*)iscal, (const int*)sched,
        (const float*)ms, (uint8_t*)codes, (float*)corner, (float*)gbuf,
        Dn, Wk, 0);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      (size_t)36 * Wk + (size_t)2 * td * ((size_t)4 * Wk + 32);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_banded_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_banded_kernel<true><<<1, threads, smem, st>>>(
      (const float*)fscal, (const int*)iscal, (const int*)sched,
      (const float*)ms, (uint8_t*)codes, (float*)corner, (float*)gbuf, Dn,
      Wk, td);
  return (int)cudaGetLastError();
}
