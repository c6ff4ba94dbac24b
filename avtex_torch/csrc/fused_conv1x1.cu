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
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at the
// SlowFast-R50 main path's embed batch (M = 58,800 .. 3,763,200 rows,
// K = 64 .. 1280, N = 64 .. 2048) 30 of the 32 calls of a tower forward
// are bound by device-memory bytes (x, out and the residual are up to
// 1.9 GB each); the res4 and res5 projections (K = 640 / 1280) by operations.
// Summed over one tower forward the bound is ~15.0 ms (~8.25 ms for the 21
// calls with K, N >= 128).
//
// Design, against the three causes that held the first (mma.sync) version
// at ~28% of that bound:
// 1. x read from device memory once. A persistent grid of one block per
//    SM walks a static list of 128 x BN output tiles in which all N-chunks
//    of one M tile are consecutive, so the blocks that run together share
//    each x tile through the 50 MB L2 instead of re-reading x from device
//    memory once per N-chunk. For N <= 256 one tile covers all of N.
// 2. An epilogue that is stored whole and overlaps the next tile. One
//    producer warp TMA-loads the tile's residual into shared memory and
//    bulk-copies scale and bias beside it while the tile's product runs.
//    The epilogue runs on the fp32 accumulators in registers (one bf16
//    rounding), writes the tile to shared memory with stmatrix and stores
//    it with TMA (which clips the ragged M and N edges). Without a
//    residual the store drains while the next tile's product runs and is
//    waited for only before the next epilogue writes the buffer; with one,
//    the buffer takes the next residual once the store has read it.
// 3. A deep pipeline. Another producer warp keeps a ring of 3-8 stages of
//    64-wide k slabs of x and w in flight with TMA (128-byte swizzle,
//    zero-filled ragged M and K edges, full/empty mbarriers), across tile
//    boundaries. Two consumer warpgroups of 64 rows each multiply with
//    wgmma (bf16 -> fp32) straight from shared memory; setmaxnreg moves
//    registers from the producer warpgroup to them.
//
// Contract (checked here and by avtex_torch/ops/fused_matmul.py): bf16;
// K % 8 == 0 and N % 8 == 0 (TMA's 16-byte row strides); x, w, residual,
// out, scale and bias 16-byte aligned; M < 2^31.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;       // rows of a tile: two warpgroups of 64
constexpr int BK = 64;        // k slab: one 128-byte swizzle row of bf16
constexpr int SUB = 64;       // rows and columns of one epilogue TMA box
constexpr int THREADS = 384;  // producer warpgroup + two consumer ones
constexpr int SUB_BYTES = SUB * SUB * 2;

// Shared-memory plan for a tile of BM x BN, offsets from a 1024-byte
// aligned base: the ring of x and w slabs, then per consumer warpgroup its
// 64 x BN epilogue tile (residual in, output out) and its scale and bias.
template <int BN>
struct Plan {
  static constexpr int STAGES = BN == 256 ? 3 : BN == 128 ? 5 : 8;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int EPI_BYTES = SUB * BN * 2;
  static constexpr int SB_BYTES = 2 * BN * 4;
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = A_OFF + STAGES * A_BYTES;
  static constexpr int EPI_OFF = B_OFF + STAGES * B_BYTES;
  static constexpr int SB_OFF = EPI_OFF + 2 * EPI_BYTES;
  static constexpr int BAR_OFF = SB_OFF + 2 * SB_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 4) + 1024;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    fused_conv1x1_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_res,
                         const __grid_constant__ CUtensorMap map_out,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, int M, int N, int K,
                         int has_res, int relu) {
  using P = Plan<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* sb_all =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + P::SB_OFF);
  const uint32_t full = base + P::BAR_OFF;        // x/w slab landed
  const uint32_t empty = full + 8 * P::STAGES;    // slab consumed
  const uint32_t epi_full = empty + 8 * P::STAGES;  // residual etc. landed
  const uint32_t epi_empty = epi_full + 16;       // epilogue tile stored

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(epi_full + 8 * c, 1);
      mbar_init(epi_empty + 8 * c, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int nk = (K + BK - 1) / BK;

  if (warp < 4) {
    // ---- producer warpgroup: warp 0 feeds the ring, warp 1 the epilogue
    setmaxnreg_dec<40>();
    if (warp == 0 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM;
        const int n0 = tile % n_tiles * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_arrive_expect_tx(bar, P::A_BYTES + P::B_BYTES);
          tma_load_2d(base + P::A_OFF + stage * P::A_BYTES, &map_x, kb * BK,
                      m0, bar);
          tma_load_2d(base + P::B_OFF + stage * P::B_BYTES, &map_w, kb * BK,
                      n0, bar);
          if (++stage == P::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (warp == 1 && lane == 0) {
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM;
        const int n0 = tile % n_tiles * BN;
        const int cols = min(BN, N - n0);
        const int boxes = (cols + SUB - 1) / SUB;
        for (int c = 0; c < 2; ++c) {
          // A half tile wholly past M loads no residual and stores nothing.
          const bool res = has_res && m0 + c * SUB < M;
          mbar_wait(epi_empty + 8 * c, phase ^ 1);
          const uint32_t bar = epi_full + 8 * c;
          const uint32_t sb = base + P::SB_OFF + c * P::SB_BYTES;
          mbar_arrive_expect_tx(bar,
                                2 * cols * 4 + (res ? boxes * SUB_BYTES : 0));
          if (res) {
            for (int b = 0; b < boxes; ++b)
              tma_load_2d(base + P::EPI_OFF + c * P::EPI_BYTES + b * SUB_BYTES,
                          &map_res, n0 + b * SUB, m0 + c * SUB, bar);
          }
          bulk_load(sb, scale + n0, cols * 4, bar);
          bulk_load(sb + BN * 4, bias + n0, cols * 4, bar);
        }
        phase ^= 1;
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64c .. 64c + 63 of every tile -------
    setmaxnreg_inc<232>();
    const int c = warp / 4 - 1;
    const int wq = warp % 4;  // rows 16 wq .. 16 wq + 15 of the 64
    const bool storer = threadIdx.x % 128 == 0;
    const uint32_t epi = base + P::EPI_OFF + c * P::EPI_BYTES;
    const float* sb = sb_all + c * (P::SB_BYTES / 4);
    // ldmatrix / stmatrix address of this lane: matrix mi = lane / 8 of
    // each 16 x 16 block, row rr of it.
    const int mi = lane / 8, rr = lane % 8;
    const int row = wq * 16 + (mi & 1) * 8 + rr;
    const int t2 = (lane % 4) * 2;
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0, ephase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * BM;
      const int n0 = tile % n_tiles * BN;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a =
            base + P::A_OFF + stage * P::A_BYTES + c * SUB * 128;
        const uint32_t b = base + P::B_OFF + stage * P::B_BYTES;
        fence_operands<BN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64k16<BN>(acc, sw128_desc(a + kk * 32),
                           sw128_desc(b + kk * 32), (kb | kk) != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands<BN / 2>(acc);
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        if (++stage == P::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // Epilogue: 16 x 16 blocks of this warp's rows; register i of the
      // ldmatrix / stmatrix quad is n8 group 2 jj + i / 2, row half i % 2.
      mbar_wait(epi_full + 8 * c, ephase);
      ephase ^= 1;
      if (!has_res) {
        // The previous tile's TMA store drained during this tile's
        // product; wait for it only now, before the buffer is written.
        if (storer) bulk_wait_read<0>();
        named_barrier_sync(1 + c, 128);
      }
#pragma unroll
      for (int jj = 0; jj < BN / 16; ++jj) {
        const int chunk = 2 * (jj % 4) + (mi >> 1);
        const uint32_t addr =
            epi + (jj / 4) * SUB_BYTES + row * 128 + ((chunk ^ rr) << 4);
        uint32_t q[4] = {0u, 0u, 0u, 0u};
        if (has_res) ldmatrix_x4(q, addr);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * jj + h;
          const float2 s = *reinterpret_cast<const float2*>(sb + 8 * j + t2);
          const float2 o = *reinterpret_cast<const float2*>(sb + BN + 8 * j +
                                                            t2);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float v0 = acc[4 * j + 2 * half] * s.x + o.x;
            float v1 = acc[4 * j + 2 * half + 1] * s.y + o.y;
            if (has_res) {
              const float2 r = __bfloat1622float2(
                  *reinterpret_cast<__nv_bfloat162*>(&q[2 * h + half]));
              v0 += r.x;
              v1 += r.y;
            }
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
            q[2 * h + half] = *reinterpret_cast<const uint32_t*>(&p);
          }
        }
        stmatrix_x4(addr, q);
      }
      fence_proxy_async();
      named_barrier_sync(1 + c, 128);
      if (storer) {
        if (!has_res) mbar_arrive(epi_empty + 8 * c);  // scale, bias read
        if (m0 + c * SUB < M) {
          const int boxes = (min(BN, N - n0) + SUB - 1) / SUB;
          for (int b = 0; b < boxes; ++b)
            tma_store_2d(&map_out, epi + b * SUB_BYTES, n0 + b * SUB,
                         m0 + c * SUB);
        }
        bulk_commit();
        if (has_res) {
          bulk_wait_read<0>();  // the buffer takes the next residual
          mbar_arrive(epi_empty + 8 * c);
        }
      }
    }
    if (storer) bulk_wait<0>();
  }
}

// The tile width for N: one tile over N <= 256, else 128 or 256, whichever
// pads less (256 on a tie: fewer tiles share each x tile).
int tile_n(int N) {
  if (N <= 64) return 64;
  if (N <= 128) return 128;
  if (N <= 256) return 256;
  const int pad128 = (128 - N % 128) % 128;
  const int pad256 = (256 - N % 256) % 256;
  return pad256 <= pad128 ? 256 : 128;
}

template <int BN>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, const void* residual, void* out, int M, int N,
           int K, int relu, cudaStream_t stream) {
  using P = Plan<BN>;
  CUtensorMap mx, mw, mr, mo;
  if (!bf16_map_2d(&mx, x, K, M, BK, BM) ||
      !bf16_map_2d(&mw, w, K, N, BK, BN) ||
      !bf16_map_2d(&mo, out, N, M, SUB, SUB) ||
      !bf16_map_2d(&mr, residual ? residual : out, N, M, SUB, SUB))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_conv1x1_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  fused_conv1x1_kernel<BN><<<grid, THREADS, P::SMEM, stream>>>(
      mx, mw, mr, mo, scale, bias, M, N, K, residual != nullptr, relu);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  const bool ok = M > 0 && M < (1LL << 31) && N > 0 && K > 0 && K % 8 == 0 &&
                  N % 8 == 0 && aligned16(x) && aligned16(w) &&
                  aligned16(out) && aligned16(scale) && aligned16(bias) &&
                  aligned16(residual);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M);
  switch (tile_n(N)) {
    case 64:
      return launch<64>(x, w, sc, bi, residual, out, m, N, K, relu, s);
    case 128:
      return launch<128>(x, w, sc, bi, residual, out, m, N, K, relu, s);
    default:
      return launch<256>(x, w, sc, bi, residual, out, m, N, K, relu, s);
  }
}
