// All-pairs L2 distance between the rows of x for Hopper.
//
//   out[i, j] = sqrt(max(sq[i] + sq[j] - 2 * dot(x[i], x[j]), 0)),  out[i, i] = 0
//
// x is fp32 [n, f], row-major; sq[i] = |x[i]|^2 is computed by the caller
// (avtex_torch/ops/pairwise.py), as avtex computes it outside its kernel.
// out is fp32 [n, n].
//
// Replaces the TPU kernel avtex/ops/pairwise.py::pairwise_l2_pallas
// (_kernel, pallas_call at line 74).
//
// What bounds it on an H100: 2 n^2 f operations against n f + n^2 floats
// moved; at the classic path's shape (n = 1800 frames, f = 224*224*3) that
// is ~1000 flop/byte, so it is bound by operations. It must stay in full
// fp32 (FFMA on the CUDA cores, not TF32): at RGB magnitudes sq reaches
// ~2.4e9, and TF32's 10-bit mantissa would swamp the distance between two
// similar frames.
//
// Design (simple first):
// - D is symmetric, so only the output tiles on and above the diagonal are
//   computed (blockIdx.x enumerates that triangle); a block off the
//   diagonal stores its tile and its transpose.
// - One 128x128 output tile per block of 256 threads, 8x8 outputs per
//   thread in registers. Both row tiles are staged through shared memory
//   k-major in 16-wide k slabs, double-buffered: the next slab's global
//   loads are in flight in registers while the current one is multiplied.
//   The k loop lives inside the block (blocks run in parallel, in no order).
// - Accumulation is two-level: each thread sums `flush` slabs (about
//   sqrt(f) k) in `part`, then adds it to `acc`, so both sums are about
//   sqrt(f) terms long. One running fp32 sum over f = 150528 terms drifts
//   by ~1e-4 of |x_i|^2 + |x_j|^2, more than the distance between two
//   similar frames after the Gram form's cancellation; the balanced two
//   levels keep it to 1.4e-6 on the classic path's RGB rows and 6.2e-6 on
//   unit rows (chip_smoke.py phase 6 prints it against an fp64 Gram). An
//   fp64 `acc` would be tighter still, at 64 more registers a thread (the
//   kernel uses 211 of 255).
// - The epilogue (sq_i + sq_j - 2 acc, clamp at 0, exact 0 on the
//   diagonal, IEEE sqrt) runs on the fp32 accumulator before one store.
// - Ragged n and f are masked in the kernel: out-of-range rows and k are
//   zero-filled, out-of-range outputs are not stored. No padded copies.
// - Loads are 16-byte vectors when f % 4 == 0 and x is 16-byte aligned,
//   else scalar (the launcher picks the instantiation).
// No split-k, cp.async, TMA, wgmma or 3xTF32 yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 128;        // output tile (rows and columns)
constexpr int BK = 16;         // k slab staged in shared memory
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int LDS = BT + 4;    // padded shared row, in floats (16-byte multiple)

// Row tile [BT, BK] of x at (row0, k0) into registers: thread t holds rows
// row0 + t/4 and row0 + t/4 + 64, k in [k0 + 4 (t%4), k0 + 4 (t%4) + 4).
template <bool VEC>
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int n,
                                          long long f, int row0, long long k0,
                                          float4 (&r)[2]) {
  const int t = threadIdx.x;
  const long long k = k0 + 4 * (t & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + (t >> 2) + 64 * h;
    const float* p = x + (long long)row * f + k;
    if (VEC) {
      r[h] = (row < n && k < f) ? __ldg(reinterpret_cast<const float4*>(p))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const bool ok = row < n;
      r[h].x = (ok && k + 0 < f) ? __ldg(p + 0) : 0.f;
      r[h].y = (ok && k + 1 < f) ? __ldg(p + 1) : 0.f;
      r[h].z = (ok && k + 2 < f) ? __ldg(p + 2) : 0.f;
      r[h].w = (ok && k + 3 < f) ? __ldg(p + 3) : 0.f;
    }
  }
}

// Registers -> shared, transposed to k-major: s[k][row].
__device__ __forceinline__ void store_tile(float (*s)[LDS],
                                           const float4 (&r)[2]) {
  const int t = threadIdx.x;
  const int k = 4 * (t & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (t >> 2) + 64 * h;
    s[k + 0][row] = r[h].x;
    s[k + 1][row] = r[h].y;
    s[k + 2][row] = r[h].z;
    s[k + 3][row] = r[h].w;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
pairwise_l2_kernel(const float* __restrict__ x, const float* __restrict__ sq,
                   float* __restrict__ out, int n, long long f,
                   int flush) {
  // Triangle index -> tile (bi, bj) with bi <= bj.
  const int t = blockIdx.x;
  int bj = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while (bj * (bj + 1) / 2 > t) --bj;
  while ((bj + 1) * (bj + 2) / 2 <= t) ++bj;
  const int bi = t - bj * (bj + 1) / 2;
  const int row0 = bi * BT, col0 = bj * BT;

  __shared__ __align__(16) float As[2][BK][LDS];
  __shared__ __align__(16) float Bs[2][BK][LDS];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8], part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = part[i][j] = 0.f;

  float4 ra[2], rb[2];
  load_tile<VEC>(x, n, f, row0, 0, ra);
  load_tile<VEC>(x, n, f, col0, 0, rb);
  store_tile(As[0], ra);
  store_tile(Bs[0], rb);
  __syncthreads();

  int buf = 0, slabs = 0;
  for (long long k0 = 0; k0 < f; k0 += BK) {
    const bool more = k0 + BK < f;
    if (more) {  // next slab's loads overlap this slab's products
      load_tile<VEC>(x, n, f, row0, k0 + BK, ra);
      load_tile<VEC>(x, n, f, col0, k0 + BK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    if (more) {
      store_tile(As[buf ^ 1], ra);
      store_tile(Bs[buf ^ 1], rb);
    }
    __syncthreads();
    buf ^= 1;
    if (++slabs == flush || !more) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
      slabs = 0;
    }
  }

  const bool mirror = bi != bj;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= n) continue;
    const float sq_r = sq[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (c >= n) continue;
      float d2 = fmaxf(sq_r + sq[c] - 2.f * acc[i][j], 0.f);
      if (r == c) d2 = 0.f;  // exact zeros on the diagonal
      const float v = sqrtf(d2);
      out[(long long)r * n + c] = v;
      if (mirror) out[(long long)c * n + r] = v;
    }
  }
}

}  // namespace

// Launch on `stream` without synchronising; returns the launch's CUDA
// error code (0 on success). The caller guarantees n >= 1, f >= 0, x
// 4-byte aligned, and that x, sq and out are device pointers.
extern "C" int avtex_pairwise_l2(const float* x, const float* sq, float* out,
                                 int n, long long f, void* stream) {
  const int tiles = (n + BT - 1) / BT;
  const int blocks = tiles * (tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // slabs per `part`: about sqrt(f) k, at least one slab
  const int root = (int)llround(sqrt((double)f) / BK);
  const int flush = root > 1 ? root : 1;
  const bool vec = (f % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (vec)
    pairwise_l2_kernel<true><<<blocks, THREADS, 0, s>>>(x, sq, out, n, f,
                                                        flush);
  else
    pairwise_l2_kernel<false><<<blocks, THREADS, 0, s>>>(x, sq, out, n, f,
                                                         flush);
  return static_cast<int>(cudaGetLastError());
}
