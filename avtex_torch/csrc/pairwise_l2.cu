// All-pairs L2 distance between the rows of x for Hopper.
//
//   out[i, j] = sqrt(max(sq[i] + sq[j] - 2 * dot(x[i], x[j]), 0)),  out[i, i] = 0
//
// x is fp32 [n, f], row-major; sq[i] = |x[i]|^2 is computed by the caller
// (avtex_torch/ops/pairwise.py), as avtex computes it outside its kernel.
// out is fp32 [n, n], exactly symmetric.
//
// Replaces the TPU kernel avtex/ops/pairwise.py::pairwise_l2_pallas
// (_kernel, pallas_call at line 74).
//
// What bounds it on an H100: operations. The n(n+1)/2 distinct row
// products cost n(n+1) f fp32 operations against n f + n^2 floats moved;
// at the classic path's shape (n = 1800 frames, f = 224*224*3 = 150528)
// that is 7.28 ms at the 67 TFLOP/s fp32 rate (bytes: 0.33 ms). It must
// stay in full fp32 (FFMA on the CUDA cores, no TF32): at RGB magnitudes
// sq reaches ~2.4e9, and TF32's 10-bit mantissa would swamp the distance
// between two similar frames.
//
// Design: two kernels, launched back to back on one stream.
// - pairwise_gram_kernel: split-k Gram products. D is symmetric, so only
//   the 128x128 output tiles on and above the diagonal are computed
//   (`tiles` of them). f is cut into `splits` contiguous ranges of whole
//   16-wide slabs (split s covers slabs [s*slabs/splits,
//   (s+1)*slabs/splits)), and the grid is splits x tiles blocks, split
//   major, so the blocks in flight read the same k window of the rows and
//   L2 serves all but the first read. The wrapper picks `splits` so the
//   grid is a whole number of waves of the card (ops/pairwise.py
//   ::_split_plan): at n = 1800 that is 11 splits, 1320 blocks, 5 waves of
//   two blocks on each of 132 SMs. Each block writes its fp32 partial Gram
//   to ws[split, tile] (64 KB); nothing is allocated here.
// - 256 threads, 8x8 outputs each: thread (ty, tx) owns local rows
//   4ty..4ty+3 and 64+4ty..64+4ty+3, and the same columns of tx. The rows
//   come from tile bj, the larger index and the only one that can be
//   partial; a warp whose 16 rows all lie past n skips its products (the
//   last tile row at n = 1800 holds 8 rows).
// - Loads: each slab of both operand tiles arrives by cp.async in a
//   2-stage ring, row-major, 16 floats a row, the row's four 16-byte quads
//   XOR-swizzled by (row >> 1) & 3. After a barrier the block transposes
//   the slab into a k-major buffer (conflict-free on both sides: a warp
//   moves 32 rows of one quad), the freed ring slot takes the slab after
//   next, and the products read 4 float4 per 64 FFMA from the k-major
//   buffer. So two slabs are in flight during the products.
// - Accumulation has three levels, each about sqrt of its length: `part`
//   (registers) sums `flush` slabs (~sqrt(split length) k), then is added
//   to `acc` (64 KB of shared memory, one column per thread); the second
//   kernel sums the splits. One running fp32 sum over f = 150528 terms
//   drifts by ~1e-4 of |x_i|^2 + |x_j|^2, more than the distance between
//   two similar frames after the Gram form's cancellation; short balanced
//   sums keep it near 5e-7 (chip_smoke.py phase 6 prints it against an
//   fp64 Gram). `acc` in shared memory keeps the kernel within 128
//   registers (both sums in registers take 211 and one block per SM), so
//   two blocks (2 x 112 KB: ring 32, k-major 16, acc 64) share an SM.
//   `-Xptxas -v` is printed by chip_smoke.py phase 2.
// - pairwise_epilogue_kernel: per output element, sums the partials in
//   split order 0..splits-1 (a fixed order, no atomics, so the output is
//   bit-identical from run to run), then sq_i + sq_j - 2 g, clamp at 0,
//   exact 0 on the diagonal, IEEE sqrt; each value is stored at (i, j) and
//   (j, i). In a diagonal tile only j <= i is computed and mirrored, so the
//   output is exactly symmetric by construction.
// - Ragged n and f are masked: rows >= n and k >= f are zero-filled by
//   cp.async's source size, outputs past n are not stored. No padded
//   copies. Loads are 16-byte cp.async when f % 4 == 0 and x is 16-byte
//   aligned, else 4-byte (the launcher picks the instantiation).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 128;        // output tile (rows and columns)
constexpr int BK = 16;         // k slab: 16 floats = four 16-byte quads
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int STAGES = 2;      // cp.async ring depth, in slabs
constexpr int PER = 64;        // outputs per thread
constexpr int TILE = BT * BT;  // floats in one partial Gram tile
constexpr int OPERAND = BT * BK;  // floats in one operand slab
constexpr int RING_FLOATS = STAGES * 2 * OPERAND;
constexpr int KMAJ_FLOATS = 2 * OPERAND;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (RING_FLOATS + KMAJ_FLOATS + PER * THREADS);

// Triangle index -> tile (bi, bj) with bi <= bj.
__device__ __forceinline__ void tile_of(int t, int& bi, int& bj) {
  bj = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while (bj * (bj + 1) / 2 > t) --bj;
  while ((bj + 1) * (bj + 2) / 2 <= t) ++bj;
  bi = t - bj * (bj + 1) / 2;
}

// Local row (or column) of output i (or j) < 8 of thread coordinate c < 16.
__device__ __forceinline__ int owned(int c, int i) {
  return i < 4 ? 4 * c + i : 64 + 4 * c + i - 4;
}

// Float offset of quad q of row r in a ring slab ([BT, BK], row-major):
// the cp.async stores of a warp (8 rows x 4 quads) and the transpose's
// reads (32 rows of one quad) are both free of bank conflicts.
__device__ __forceinline__ int swz(int r, int q) {
  return r * BK + 4 * (q ^ ((r >> 1) & 3));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One thread's share of a slab's copies: quad t % 4 of rows t / 4 and
// t / 4 + 64 of both operand tiles. `src[u]` points at the quad's first
// float at k = 0 (u = 2 * operand + h), or is null for a row >= n.
struct SlabCopy {
  const float* src[4];
};

// Slab starting at k0 into the ring slab s ([2][BT][BK], swizzled); rows
// >= n and k >= f arrive as zeros.
template <bool VEC>
__device__ __forceinline__ void load_slab(float* s, const SlabCopy& c,
                                          const float* __restrict__ x,
                                          long long f, long long k0) {
  const int t = threadIdx.x;
  const int q = t & 3;
  const long long k = k0 + 4 * q;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float* d = s + (u >> 1) * OPERAND + swz((t >> 2) + 64 * (u & 1), q);
    const float* p = c.src[u];
    if (VEC) {  // f % 4 == 0: a quad is wholly inside f or wholly past it
      const bool in = p != nullptr && k < f;
      cp_async16(d, in ? p + k0 : x, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = p != nullptr && k + e < f;
        cp_async4(d + e, in ? p + k0 + e : x, in ? 4 : 0);
      }
    }
  }
}

// Ring slab (row-major, swizzled) -> k-major kmaj[operand][k][row]. Each
// warp moves 32 consecutive rows of one quad: 4 conflict-free wavefronts
// to read, one per store.
__device__ __forceinline__ void transpose_slab(float* __restrict__ kmaj,
                                               const float* __restrict__ s) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int idx = p * THREADS + threadIdx.x;
    const int op = idx >> 9, q = (idx >> 7) & 3, r = idx & 127;
    const float4 v =
        *reinterpret_cast<const float4*>(s + op * OPERAND + swz(r, q));
    float* d = kmaj + op * OPERAND + (4 * q) * BT + r;
    d[0] = v.x;
    d[BT] = v.y;
    d[2 * BT] = v.z;
    d[3 * BT] = v.w;
  }
}

// part[i][j] += x[row i] . x[col j] over the 16 k of the k-major slab, k
// ascending: 4 float4 reads from shared memory per 64 FFMA.
__device__ __forceinline__ void multiply_slab(float (&part)[8][8],
                                              const float* __restrict__ kmaj,
                                              int tx, int ty) {
  const float* As = kmaj;
  const float* Bs = kmaj + OPERAND;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * BT + 4 * ty);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * BT + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * BT + 4 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * BT + 64 + 4 * tx);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
pairwise_gram_kernel(const float* __restrict__ x, float* __restrict__ ws,
                     int n, long long f, int tiles, int splits, int flush) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                       // [STAGES][2][BT][BK]
  float* kmaj = smem + RING_FLOATS;         // [2][BK][BT]
  float* acc = kmaj + KMAJ_FLOATS;          // [PER][THREADS]

  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  int bi, bj;
  tile_of(tile, bi, bj);
  // rows from the larger tile index, the only one that can be partial
  const int row0 = bj * BT, col0 = bi * BT;
  const long long slabs = (f + BK - 1) / BK;
  const long long s0 = slabs * split / splits;
  const int nslab = (int)(slabs * (split + 1) / splits - s0);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // warp w owns local rows 8w..8w+7 and 64+8w..64+8w+7: past n it skips
  // its products (the last tile row of n = 1800 has 8 rows, warp 0's)
  const bool active = row0 + 8 * (tid >> 5) < n;
  SlabCopy cp;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = ((u >> 1) ? col0 : row0) + (tid >> 2) + 64 * (u & 1);
    cp.src[u] = row < n ? x + (long long)row * f + 4 * (tid & 3) : nullptr;
  }
  float part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll 8
  for (int e = 0; e < PER; ++e) acc[e * THREADS + tid] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    if (st < nslab)
      load_slab<VEC>(ring + st * 2 * OPERAND, cp, x, f, (s0 + st) * BK);
    cp_async_commit();
  }

  int since = 0;
  for (int it = 0; it < nslab; ++it) {
    float* slot = ring + (it % STAGES) * 2 * OPERAND;
    cp_async_wait<STAGES - 1>();  // this thread's copies of slab `it` landed
    __syncthreads();  // everyone's have, and slab it-1's products are done
    transpose_slab(kmaj, slot);
    __syncthreads();  // kmaj holds slab `it`; its ring slot is free
    if (it + STAGES < nslab)  // two slabs in flight during the products
      load_slab<VEC>(slot, cp, x, f, (s0 + it + STAGES) * BK);
    cp_async_commit();
    if (active) multiply_slab(part, kmaj, tx, ty);
    if (++since == flush) {  // only this thread touches its acc column
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[(i * 8 + j) * THREADS + tid] += part[i][j];
          part[i][j] = 0.f;
        }
      since = 0;
    }
  }
  cp_async_wait<0>();

  float* w = ws + ((long long)split * tiles + tile) * TILE;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = i * 8 + j;
      w[e * THREADS + tid] = acc[e * THREADS + tid] + part[i][j];
    }
}

// grid (tiles, 8): block (tile, i) finishes output row i of every thread
// of the Gram kernel: the 8 outputs (i, j) that thread tid owned there.
__global__ void __launch_bounds__(THREADS)
pairwise_epilogue_kernel(const float* __restrict__ ws,
                         const float* __restrict__ sq, float* __restrict__ out,
                         int n, int tiles, int splits) {
  const int tile = blockIdx.x, i = blockIdx.y;
  int bi, bj;
  tile_of(tile, bi, bj);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r = bj * BT + owned(ty, i);  // rows from tile bj, as computed
  if (r >= n) return;
  float g[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) g[j] = 0.f;
  for (int s = 0; s < splits; ++s) {  // split order: bit-identical reruns
    const float* p = ws + ((long long)s * tiles + tile) * TILE +
                     (i * 8) * THREADS + tid;
#pragma unroll
    for (int j = 0; j < 8; ++j) g[j] += p[j * THREADS];
  }
  const float sq_r = sq[r];
  const bool diag = bi == bj;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = bi * BT + owned(tx, j);
    // a diagonal tile computes c <= r only and mirrors it
    if (c >= n || (diag && c > r)) continue;
    float d2 = fmaxf(sq_r + sq[c] - 2.f * g[j], 0.f);
    if (r == c) d2 = 0.f;  // exact zeros on the diagonal
    const float v = sqrtf(d2);
    out[(long long)r * n + c] = v;
    if (r != c) out[(long long)c * n + r] = v;
  }
}

template <bool VEC>
cudaError_t prepare() {
  static bool done = false;  // the attribute is per function, set once
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      pairwise_gram_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// Gram-kernel blocks that fit on one SM at once (the smaller of the two
// load instantiations); the wrapper plans its waves with it. Returns a
// negative CUDA error code on failure.
extern "C" int avtex_pairwise_l2_blocks_per_sm() {
  int best = 1 << 30;
  cudaError_t e = prepare<true>();
  if (e == cudaSuccess) e = prepare<false>();
  for (int v = 0; v < 2 && e == cudaSuccess; ++v) {
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, v ? (const void*)pairwise_gram_kernel<true>
                   : (const void*)pairwise_gram_kernel<false>,
        THREADS, SMEM_BYTES);
    if (blocks < best) best = blocks;
  }
  return e == cudaSuccess ? best : -(int)e;
}

// Launch both kernels on `stream` without synchronising; returns the first
// launch's CUDA error code (0 on success). The caller guarantees n >= 1,
// f >= 0, 1 <= splits <= max(1, ceil(f / 16)), x 4-byte aligned, ws
// holding splits * tiles * 128 * 128 floats (tiles = T (T + 1) / 2, T =
// ceil(n / 128)), and that x, sq, out and ws are device pointers.
extern "C" int avtex_pairwise_l2(const float* x, const float* sq, float* out,
                                 float* ws, int n, long long f, int splits,
                                 void* stream) {
  const int t = (n + BT - 1) / BT;
  const int tiles = t * (t + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // slabs per `part`: about sqrt(split length) k, at least one slab
  const double split_k = (double)f / splits;
  const int root = (int)llround(sqrt(split_k) / BK);
  const int flush = root > 1 ? root : 1;
  const bool vec = (f % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  cudaError_t e = vec ? prepare<true>() : prepare<false>();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)tiles * (unsigned)splits);
  if (vec)
    pairwise_gram_kernel<true><<<grid, THREADS, SMEM_BYTES, s>>>(
        x, ws, n, f, tiles, splits, flush);
  else
    pairwise_gram_kernel<false><<<grid, THREADS, SMEM_BYTES, s>>>(
        x, ws, n, f, tiles, splits, flush);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pairwise_epilogue_kernel<<<dim3(tiles, 8), THREADS, 0, s>>>(ws, sq, out, n,
                                                              tiles, splits);
  return (int)cudaGetLastError();
}
