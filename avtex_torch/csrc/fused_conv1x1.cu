// Fused 1x1 convolution + folded-norm affine + residual + ReLU for Hopper.
//
//   out[M, N] = act((x[M, K] @ w[N, K]^T) * scale[N] + bias[N] (+ residual[M, N]))
//
// x, w, residual and out are bf16; scale and bias are fp32. The product
// accumulates in fp32 and is rounded to bf16 once, at the store. act is
// ReLU when `relu` is set. w is in torch's [out, in] layout (a conv weight
// viewed as [N, K]), so both operands are K-contiguous.
//
// Replaces the TPU kernel avtex/ops/fused_matmul.py::fused_conv1x1
// (_kernel_res / _kernel_nores, pallas_call at line 192).
//
// What bounds it on an H100: at the SlowFast-R50 shapes (K = 128..1280,
// N = 128..2048, M up to millions of rows) the arithmetic intensity of the
// fused call is 2MKN / (2(MK + KN + MN [+ MN])) ~ 50..400 flop/byte, so
// the small-K, small-N calls are bound by device-memory bytes and the
// large ones sit near the ridge (~295 flop/byte in bf16). The design keeps
// every byte to one pass: x and w tiles are read through shared memory,
// the epilogue (scale, bias, residual, ReLU) runs on the fp32 accumulator
// in registers, and out is written once -- there is no separate
// elementwise pass over the largest activation of the block.
//
// Design (simple first): a 128x128 output tile per block of 8 warps, each
// warp 64x32, bf16 mma.sync.m16n8k16 tensor-core instructions with
// ldmatrix operand loads from padded shared memory (80-byte rows, no bank
// conflicts), and a two-stage cp.async pipeline over 32-wide k slabs. The
// k loop lives inside the block (blocks run in parallel, in no order). The
// ragged M, N and K edges are masked: out-of-range operand chunks of 8
// elements are zero-filled, out-of-range outputs are not stored. The
// caller guarantees K % 8 == 0, N even, x and w 16-byte aligned and
// residual and out 4-byte aligned (avtex_torch/ops/fused_matmul.py checks
// it), so every load is one 16-byte cp.async and every store one bf16
// pair. No wgmma/TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDS = BK + 8;  // padded shared-memory row, in bf16 elements
constexpr int THREADS = 256;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy a [128 rows, 32 k] slab of a K-contiguous [rows, K] operand into
// shared memory, zero-filling rows >= `rows` and columns >= K.
__device__ __forceinline__ void load_slab(bf16 (*dst)[LDS],
                                          const bf16* __restrict__ src,
                                          int64_t rows, int K, int64_t row0,
                                          int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;  // 512 chunks of 8 bf16
    const int r = c >> 2;
    const int kc = (c & 3) * 8;
    const int64_t gr = row0 + r;
    const int gk = k0 + kc;
    const bool valid = gr < rows && gk < K;  // K % 8 == 0: whole chunk
    const bf16* p = valid ? src + gr * K + gk : src;
    cp_async16(smem_addr(&dst[r][kc]), p, valid);
  }
}

__global__ void __launch_bounds__(THREADS)
    fused_conv1x1_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const bf16* __restrict__ residual,
                         bf16* __restrict__ out, int64_t M, int N, int K,
                         int relu) {
  __shared__ __align__(128) bf16 As[2][BM][LDS];
  __shared__ __align__(128) bf16 Bs[2][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps down M: 64 rows each
  const int wn = warp & 3;   // 4 warps across N: 32 columns each
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int num_k = (K + BK - 1) / BK;
  load_slab(As[0], x, M, K, m0, 0, tid);
  load_slab(Bs[0], w, N, K, n0, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < num_k; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < num_k) {
      load_slab(As[s ^ 1], x, M, K, m0, (kt + 1) * BK, tid);
      load_slab(Bs[s ^ 1], w, N, K, n0, (kt + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(a[i][0], a[i][1], a[i][2], a[i][3],
                    smem_addr(&As[s][r][c]));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = wn * 32 + j * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b[2 * j][0], b[2 * j][1], b[2 * j + 1][0],
                    b[2 * j + 1][1], smem_addr(&Bs[s][r][c]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // Epilogue on the fp32 accumulator: scale, bias, residual, ReLU, one
  // rounding to bf16. Thread (g, t) of a warp holds rows g and g + 8 and
  // columns 2t, 2t + 1 of every 16x8 accumulator tile.
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + t * 2;
    if (col >= N) continue;  // N even: col + 1 < N too
    const float s0 = scale[col];
    const float b0 = bias[col];
    const float s1 = scale[col + 1];
    const float b1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm * 64 + i * 16 + g + h * 8;
        if (row >= M) continue;
        const int64_t off = row * N + col;
        float v0 = acc[i][j][2 * h] * s0 + b0;
        float v1 = acc[i][j][2 * h + 1] * s1 + b1;
        if (residual != nullptr) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(residual + off));
          v0 += r.x;
          v1 += r.y;
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + off) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// Plain C launcher for ctypes. Launches on `stream` without synchronising
// and returns cudaGetLastError() (0 on success). `residual` may be null.
// Shapes and alignment the kernel does not take give cudaErrorInvalidValue
// (the Python wrapper raises on them before it gets here).
extern "C" int avtex_fused_conv1x1(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   const void* residual, void* out,
                                   long long M, int N, int K, int relu,
                                   void* stream) {
  const bool ok = M > 0 && N > 0 && K > 0 && K % 8 == 0 && N % 2 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(residual) % 4 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const bf16* rb = static_cast<const bf16*>(residual);
  bf16* ob = static_cast<bf16*>(out);
  fused_conv1x1_kernel<<<grid, THREADS, 0, s>>>(xb, wb, sc, bi, rb, ob, M, N,
                                                K, relu);
  return static_cast<int>(cudaGetLastError());
}
