// One whole SlowFast bottleneck per launch, for Hopper.
//
//   y1  = bf16(relu(x @ w1 * s1 + b1))                      1x1, [.., F]
//   y2  = bf16(relu(conv3x3(y1, pad 1, stride) * s2 + b2))  [.., F]
//   r   = x[::s, ::s] @ wp * sp + bp   (fp32; block 0)   or   x (Cin == Cout)
//   out = bf16(relu(y2 @ w3 * s3 + b3 + r))                 [.., Cout]
//
// on channels-last slices x [BT, H, W, Cin] -> out [BT, H/s, W/s, Cout].
// x, the weights and out are bf16; the scale/bias vectors fp32. Products
// accumulate in fp32 and round to bf16 exactly where the TPU kernel does
// (after conv1's and conv2's affine + ReLU, and at the block's output); the
// projection is added in fp32 before the final rounding.
//
// Replaces the TPU kernel avtex/ops/stage_fused.py::fused_stage
// (_stage_kernel / _block_body, pallas_call at line 293). The Python wrapper
// (avtex_torch/ops/stage_fused.py) chains one launch per bottleneck, so a
// stage of N blocks is N launches; each block's output passes through device
// memory in bf16, where the TPU kernel rounds it too.
//
// What bounds it on an H100: a slow-pathway stage does 2.6 TFLOP (res3) on
// ~3.4 GB of stage input and output at the main path's 1200 slices, so the
// stage is bound by operations (~295 flop/byte is the bf16 ridge); the
// handoffs between blocks add bytes but stay under the operations bound for
// res3. The design keeps conv1's and conv2's outputs on the chip: they live
// only in shared memory, never in device memory.
//
// Design (simple first). A block of 8 warps owns an output tile of TH x TW
// <= 64 pixels of one (b, t) slice. It
//   A. recomputes conv1 on the tile's halo ((TH-1)s+3 x (TW-1)s+3 input
//      pixels) in 64-row chunks, writing y1 into shared memory; halo pixels
//      outside the image are 0 (the 3x3 conv pads y1, the output of the
//      ReLU, not x);
//   B. runs the 3x3 conv as one product with K = 9F whose A rows are read
//      from y1 in shared memory at the tap's offset (implicit im2col, one
//      ldmatrix row address per lane), writing y2 into shared memory;
//   C. runs conv3 (and the projection on block 0) in 128-column chunks of
//      Cout and applies the epilogue on the fp32 accumulators in registers.
// Every product is bf16 mma.sync.m16n8k16 with fp32 accumulators; B
// (weights, [N, K] K-contiguous, read from L2) and global A rows stream
// through a two-stage cp.async ring of 64-wide k slabs. Warps are 4 down the
// 64 rows x 2 across the columns. The host picks TH x TW per shape to
// minimise padded work. No wgmma/TMA yet, and every block re-reads the
// block's weights from L2.
//
// The wrapper guarantees Cin % 8 == 0, F % 16 == 0, F <= 128,
// Cout % 16 == 0, Cin == Cout when there is no projection, even H and W at
// stride 2, and 16-byte aligned contiguous operands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps: 4 down the rows x 2 across columns
constexpr int BM = 64;        // rows of one product tile (output pixels)
constexpr int BN = 128;       // widest column chunk of one product tile
constexpr int BK = 64;        // k slab
constexpr int LDK = BK + 8;   // padded slab row: 144 B, conflict-free ldmatrix
constexpr int MAX_F = 128;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use

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

struct Params {
  const bf16* x;
  const bf16* w1;  // [F, Cin]
  const float* s1;
  const float* b1;
  const bf16* w2;  // [F, 9F], k = (dh * 3 + dw) * F + c
  const float* s2;
  const float* b2;
  const bf16* w3;  // [Cout, F]
  const float* s3;
  const float* b3;
  const bf16* wp;  // [Cout, Cin] or null (the residual is x)
  const float* sp;
  const float* bp;
  bf16* out;
  int H, W, Ho, Wo, cin, f, cout, stride;
  int TH, TW, HH, HW, tiles_w, tiles;  // output tile, its conv1 halo
};

struct Smem {
  bf16* Bs;  // [2][BN][LDK]
  bf16* As;  // [2][BM][LDK]
  bf16* y2;  // [BM][F + 8]
  bf16* y1;  // [HH * HW][F + 8]
};

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// Columns each of the two column warps covers for a product of width N:
// 64 for N >= 128, else half of N rounded up to 32 (at least 16).
__device__ __forceinline__ int warp_cols(int N) {
  const int n = N < BN ? N : BN;
  const int half = ((n + 31) / 32) * 16;
  return half < 16 ? 16 : half;
}

// acc += A[64 rows, K] @ B[n0 : n0 + 2 * warp_cols(N), K]^T for this warp's
// 16 rows (wm) and warp_cols(N) columns (wn). B is [N, K] K-contiguous in
// global memory; rows >= N and k >= K are zero-filled. A rows come either
// from global memory (kGlobalA: a_rows holds the start of the two rows this
// thread copies, nullptr for a zero row) through the As ring, or from shared
// memory (a_smem(k): the shared address of this lane's ldmatrix row at
// column k; then K % 16 == 0). `active` is false for a warp whose 16 rows are
// all padding: it still copies and synchronises but runs no mma. Ends with
// __syncthreads(), so the ring may be refilled at once.
template <bool kGlobalA, typename ASmem>
__device__ __forceinline__ void gemm(float (&acc)[8][4], const Smem& sm,
                                     const bf16* const (&a_rows)[2],
                                     ASmem a_smem, const bf16* __restrict__ B,
                                     int N, int K, int n0, bool active) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int wc = warp_cols(N);
  const int cr = tid >> 3;        // first row this thread copies
  const int kc = (tid & 7) * 8;   // its 8-element column chunk
  const int num_k = (K + BK - 1) / BK;

  auto load = [&](int stage, int k0) {
    const bool kin = k0 + kc < K;  // K % 8 == 0: a chunk is all in or out
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = cr + 32 * i;
      const bool valid = kin && n0 + r < N;
      const bf16* p = valid ? B + static_cast<int64_t>(n0 + r) * K + k0 + kc
                            : B;
      cp_async16(smem_addr(sm.Bs + (stage * BN + r) * LDK + kc), p, valid);
    }
    if (kGlobalA) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = cr + 32 * i;
        const bool valid = kin && a_rows[i] != nullptr;
        const bf16* p = valid ? a_rows[i] + k0 + kc : B;
        cp_async16(smem_addr(sm.As + (stage * BM + r) * LDK + kc), p, valid);
      }
    }
  };

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < num_k; ++kt) {
    const int s = kt & 1;
    const int k0 = kt * BK;
    if (kt + 1 < num_k) {
      load(s ^ 1, k0 + BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        if (k0 + kk >= K) break;
        uint32_t a[4];
        if (kGlobalA) {
          const int r = wm * 16 + (lane & 15);
          const int c = kk + (lane >> 4) * 8;
          ldmatrix_x4(a[0], a[1], a[2], a[3],
                      smem_addr(sm.As + (s * BM + r) * LDK + c));
        } else {
          ldmatrix_x4(a[0], a[1], a[2], a[3],
                      a_smem(k0 + kk + (lane >> 4) * 8));
        }
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          const int cb = wn * wc + j2 * 16;  // column within the chunk
          if (j2 * 16 >= wc || n0 + cb >= N) break;  // N % 16 == 0
          uint32_t b[2][2];
          const int r = cb + (lane & 7) + ((lane >> 4) << 3);
          const int c = kk + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(b[0][0], b[0][1], b[1][0], b[1][1],
                      smem_addr(sm.Bs + (s * BN + r) * LDK + c));
          mma_bf16_16816(acc[2 * j2], a, b[0]);
          mma_bf16_16816(acc[2 * j2 + 1], a, b[1]);
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
    fused_block_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldf = p.f + 8;  // padded y1/y2 row: an odd number of 16 B
  Smem sm;
  sm.Bs = reinterpret_cast<bf16*>(smem_raw);
  sm.As = sm.Bs + 2 * BN * LDK;
  sm.y2 = sm.As + 2 * BM * LDK;
  sm.y1 = sm.y2 + BM * ldf;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int g = lane >> 2;  // accumulator rows g, g + 8
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 of each n8

  const int slice = blockIdx.x / p.tiles;
  const int tile = blockIdx.x - slice * p.tiles;
  const int oh0 = (tile / p.tiles_w) * p.TH;
  const int ow0 = (tile % p.tiles_w) * p.TW;
  const int s = p.stride;
  const int P = p.TH * p.TW;      // output pixels of the tile (<= 64)
  const int P1 = p.HH * p.HW;     // halo pixels of y1
  const int iy0 = oh0 * s - 1;    // image row/col of halo pixel (0, 0)
  const int ix0 = ow0 * s - 1;
  const bf16* xs = p.x + static_cast<int64_t>(slice) * p.H * p.W * p.cin;
  const bf16* const no_rows[2] = {nullptr, nullptr};
  auto no_smem = [](int) { return 0u; };

  // ---- A. conv1 + affine + ReLU on the halo -> y1 (shared) ------------- //
  {
    const int wc = warp_cols(p.f);
    for (int m0 = 0; m0 < P1; m0 += BM) {
      const bf16* rows[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = m0 + (tid >> 3) + 32 * i;
        const int hy = q / p.HW;
        const int iy = iy0 + hy;
        const int ix = ix0 + q - hy * p.HW;
        rows[i] = (q < P1 && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
                      ? xs + (static_cast<int64_t>(iy) * p.W + ix) * p.cin
                      : nullptr;
      }
      float acc[8][4];
      zero(acc);
      gemm<true>(acc, sm, rows, no_smem, p.w1, p.f, p.cin, 0,
                 m0 + wm * 16 < P1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = m0 + wm * 16 + g + h * 8;
        if (q >= P1) continue;
        const int hy = q / p.HW;
        const int iy = iy0 + hy;
        const int ix = ix0 + q - hy * p.HW;
        const bool inside = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wn * wc + j * 8 + t * 2;
          if (j * 8 >= wc || col >= p.f) continue;
          float v0 = 0.f, v1 = 0.f;  // the 3x3 conv's zero padding of y1
          if (inside) {
            v0 = fmaxf(acc[j][2 * h] * p.s1[col] + p.b1[col], 0.f);
            v1 = fmaxf(acc[j][2 * h + 1] * p.s1[col + 1] + p.b1[col + 1],
                       0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(sm.y1 + q * ldf + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  __syncthreads();

  // ---- B. 3x3 conv (implicit im2col from y1) + affine + ReLU -> y2 ------ //
  {
    const int r = wm * 16 + (lane & 15);  // this lane's ldmatrix row
    int q0 = 0;                            // padding rows read y1 row 0
    if (r < P) {
      const int i = r / p.TW;
      q0 = i * s * p.HW + (r - i * p.TW) * s;
    }
    const uint32_t y1_base = smem_addr(sm.y1);
    const int f = p.f;
    const int HW = p.HW;
    auto tap_row = [=](int k) {
      const int tap = k / f;
      const int dh = tap / 3;
      const int q = q0 + dh * HW + (tap - 3 * dh);
      return y1_base + static_cast<uint32_t>((q * ldf + k - tap * f) * 2);
    };
    float acc[8][4];
    zero(acc);
    gemm<false>(acc, sm, no_rows, tap_row, p.w2, f, 9 * f, 0,
                wm * 16 < P);
    const int wc = warp_cols(f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 16 + g + h * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wn * wc + j * 8 + t * 2;
        if (j * 8 >= wc || col >= f) continue;
        const float v0 = fmaxf(acc[j][2 * h] * p.s2[col] + p.b2[col], 0.f);
        const float v1 =
            fmaxf(acc[j][2 * h + 1] * p.s2[col + 1] + p.b2[col + 1], 0.f);
        *reinterpret_cast<__nv_bfloat162*>(sm.y2 + row * ldf + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();

  // ---- C. conv3 + affine (+ projection) + residual + ReLU -> out ------- //
  {
    const bf16* prow[2] = {nullptr, nullptr};  // projection: x[::s, ::s]
    if (p.wp != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (tid >> 3) + 32 * i;
        const int oh = oh0 + r / p.TW;
        const int ow = ow0 + r % p.TW;
        if (r < P && oh < p.Ho && ow < p.Wo)
          prow[i] =
              xs + (static_cast<int64_t>(oh * s) * p.W + ow * s) * p.cin;
      }
    }
    const uint32_t y2_row =
        smem_addr(sm.y2) + static_cast<uint32_t>((wm * 16 + (lane & 15)) *
                                                 ldf * 2);
    auto y2_at = [=](int k) { return y2_row + static_cast<uint32_t>(k * 2); };
    const int wc = warp_cols(p.cout);
    const bool active = wm * 16 < P;
    for (int n0 = 0; n0 < p.cout; n0 += BN) {
      float acc[8][4];
      zero(acc);
      gemm<false>(acc, sm, no_rows, y2_at, p.w3, p.cout, p.f, n0, active);
      float accp[8][4];
      zero(accp);
      if (p.wp != nullptr)
        gemm<true>(accp, sm, prow, no_smem, p.wp, p.cout, p.cin, n0, active);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 16 + g + h * 8;
        const int oh = oh0 + r / p.TW;
        const int ow = ow0 + r % p.TW;
        if (r >= P || oh >= p.Ho || ow >= p.Wo) continue;
        const int64_t pix =
            (static_cast<int64_t>(slice) * p.Ho + oh) * p.Wo + ow;
        // without a projection: stride 1 and Cin == Cout, x is the residual
        const bf16* res = xs + (static_cast<int64_t>(oh) * p.W + ow) * p.cin;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + wn * wc + j * 8 + t * 2;
          if (j * 8 >= wc || col >= p.cout) continue;
          float v0 = acc[j][2 * h] * p.s3[col] + p.b3[col];
          float v1 = acc[j][2 * h + 1] * p.s3[col + 1] + p.b3[col + 1];
          if (p.wp != nullptr) {
            v0 += accp[j][2 * h] * p.sp[col] + p.bp[col];
            v1 += accp[j][2 * h + 1] * p.sp[col + 1] + p.bp[col + 1];
          } else {
            const float2 rv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res + col));
            v0 += rv.x;
            v1 += rv.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(p.out + pix * p.cout + col) =
              __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
    }
  }
}

int smem_bytes(int f, int HH, int HW) {
  return 2 * (2 * BN * LDK + 2 * BM * LDK + (BM + HH * HW) * (f + 8));
}

}  // namespace

// Plain C launcher for ctypes: one bottleneck on x [bt, H, W, cin] ->
// out [bt, H/stride, W/stride, cout]. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success). wp, sp and bp
// are null for a block without a projection. Shapes the kernel does not
// take give cudaErrorInvalidValue (the Python wrapper raises on them first).
extern "C" int avtex_fused_block(
    const void* x, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, const void* w3,
    const void* s3, const void* b3, const void* wp, const void* sp,
    const void* bp, void* out, int bt, int H, int W, int cin, int f, int cout,
    int stride, void* stream) {
  const bool proj = wp != nullptr;
  bool ok = bt > 0 && H > 0 && W > 0 && cin > 0 && cin % 8 == 0 && f > 0 &&
            f % 16 == 0 && f <= MAX_F && cout > 0 && cout % 16 == 0 &&
            (stride == 1 || stride == 2) &&
            (stride == 1 || (H % 2 == 0 && W % 2 == 0)) &&
            (proj || (stride == 1 && cin == cout)) &&
            (!proj || (sp != nullptr && bp != nullptr)) &&
            reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const void* mats[] = {w1, w2, w3, wp};
  for (const void* m : mats)
    ok = ok && reinterpret_cast<uintptr_t>(m) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.w3 = static_cast<const bf16*>(w3);
  p.s3 = static_cast<const float*>(s3);
  p.b3 = static_cast<const float*>(b3);
  p.wp = static_cast<const bf16*>(wp);
  p.sp = static_cast<const float*>(sp);
  p.bp = static_cast<const float*>(bp);
  p.out = static_cast<bf16*>(out);
  p.H = H;
  p.W = W;
  p.Ho = H / stride;
  p.Wo = W / stride;
  p.cin = cin;
  p.f = f;
  p.cout = cout;
  p.stride = stride;

  // Output tile TH x TW <= 64 pixels: the least padded tensor-core work,
  // counting the halo's conv1 rows and every product's rows in units of 16.
  const int64_t rest = 9LL * f * f + static_cast<int64_t>(f) * cout +
                       (proj ? static_cast<int64_t>(cin) * cout : 0);
  int64_t best = -1;
  for (int th = 1; th <= (p.Ho < BM ? p.Ho : BM); ++th) {
    int tw = BM / th;
    if (tw > p.Wo) tw = p.Wo;
    const int hh = (th - 1) * stride + 3;
    const int hw = (tw - 1) * stride + 3;
    if (smem_bytes(f, hh, hw) > MAX_SMEM) continue;
    const int64_t tiles = static_cast<int64_t>((p.Ho + th - 1) / th) *
                          ((p.Wo + tw - 1) / tw);
    const int64_t r1 = (hh * hw + 15) / 16 * 16;
    const int64_t r = (th * tw + 15) / 16 * 16;
    const int64_t cost = tiles * (r1 * cin * f + r * rest);
    if (best < 0 || cost < best) {
      best = cost;
      p.TH = th;
      p.TW = tw;
    }
  }
  if (best < 0) return static_cast<int>(cudaErrorInvalidValue);
  p.HH = (p.TH - 1) * stride + 3;
  p.HW = (p.TW - 1) * stride + 3;
  p.tiles_w = (p.Wo + p.TW - 1) / p.TW;
  p.tiles = ((p.Ho + p.TH - 1) / p.TH) * p.tiles_w;
  const int64_t blocks = static_cast<int64_t>(bt) * p.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  const int smem = smem_bytes(f, p.HH, p.HW);
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_block_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
