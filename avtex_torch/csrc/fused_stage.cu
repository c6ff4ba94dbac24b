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
// res3. conv1's and conv2's outputs live only in shared memory.
//
// Design. The output is cut into tiles of TH x TW <= 64 x NWG pixels of one
// (b, t) slice; the tile, NWG and the depth of the weight ring come from
// the host's plan (stage_fused.plan); a block owns one tile. In each block
// a producer warpgroup feeds two rings of 64-k-wide
// slabs, each slot with a full and an empty mbarrier, in the static order
// the consumers take them: lane 0 of its first warp streams every weight
// slab by TMA (128-byte swizzle, zero-filled past N and K); its next two
// warps gather the x rows that conv1 and the projection multiply with
// 16-byte cp.async copies (zero-filled outside the image and past K;
// chunks XOR-swizzled by row) that arrive on the slot's barrier as they
// land. NWG consumer warpgroups each own 64 rows of every product and
// multiply with the register-fed wgmma: the A fragments come from ldmatrix
// (a gathered slot is released as soon as they are in registers), B from
// the weight ring; setmaxnreg moves registers from the producer to them.
// They
//   A. compute conv1 on the tile's halo ((TH-1)s+3 x (TW-1)s+3 input
//      pixels) in 64-row chunks, writing y1 into shared memory; halo pixels
//      outside the image are 0 (the 3x3 conv pads y1, the output of the
//      ReLU, not x);
//   B. run the 3x3 conv as one product with K = 9F whose A fragments are
//      ldmatrix'd from y1 at the tap's offset (implicit im2col, one row
//      address per lane), then write y2 over y1 once every warp is done
//      with y1;
//   C. run conv3 (A from y2) and, on block 0, the projection (A gathered
//      from x[::s, ::s]) in 128-column chunks of Cout, and apply the
//      epilogue on the fp32 accumulators in registers. Without a
//      projection the residual rows are copied into the (then idle) A ring
//      while conv3 multiplies, and the output rows leave from there, both
//      in 16-byte coalesced copies.
// Each weight slab is one wgmma group; the next slab's A fragments load
// while it runs, and its weight slot is released once the group has
// retired.
// Widths below 64 (F = 16, 32 in small tests) run padded to 64 columns:
// TMA zero-fills the missing weight rows and the epilogues mask them.
//
// The launcher checks Cin % 8 == 0, F % 16 == 0, F <= 128, Cout % 16 == 0,
// Cin == Cout when there is no projection, even H and W at stride 2,
// 16-byte aligned operands and the plan; the wrapper raises first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;        // rows of one warpgroup's product
constexpr int BK = 64;        // k slab: one 128-byte swizzle row of bf16
constexpr int BN3 = 128;      // column chunk of conv3 and the projection
constexpr int A_STAGES = 4;   // slots of the ring of gathered A slabs
constexpr int A_SLOT_BYTES = BM * BK * 2;    // a warpgroup's share of a slot
constexpr int B_STAGE_BYTES = BN3 * BK * 2;  // one slot: the widest box
constexpr int GATHER_THREADS = 64;  // producer warps 1 and 2
constexpr int STAGE_WARP_BYTES = 16 * BN3 * 2;  // a warp's rows of output
static_assert(4 * STAGE_WARP_BYTES <= A_STAGES * A_SLOT_BYTES,
              "the output rows of a warpgroup fit its share of the A ring");
constexpr int MAX_B_STAGES = 8;
constexpr int MAX_F = 128;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use

typedef __nv_bfloat16 bf16;

// Shared-memory plan, byte offsets from a 1024-byte aligned base: the
// weight ring, the ring of gathered A slabs (64 x NWG rows of 128 bytes a
// slot), y1 (later y2 over it; at least 64 x NWG rows of F + 8), both
// rings' barriers. stage_fused.smem_bytes in Python computes the same
// total.
struct Layout {
  int a, y, bar, bytes;
};

__host__ __device__ inline Layout layout(int f, int nwg, int stages,
                                         int halo_rows) {
  Layout L;
  L.a = stages * B_STAGE_BYTES;
  L.y = L.a + A_STAGES * nwg * A_SLOT_BYTES;
  const int rows = halo_rows > BM * nwg ? halo_rows : BM * nwg;
  L.bar = L.y + (rows * (f + 8) * 2 + 15) / 16 * 16;
  L.bytes = L.bar + 16 * (stages + A_STAGES) + 1024;  // + slack to align
  return L;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

struct Params {
  const bf16* x;
  const float* s1;
  const float* b1;
  const float* s2;
  const float* b2;
  const float* s3;
  const float* b3;
  const float* sp;  // null without a projection (the residual is x)
  const float* bp;
  bf16* out;
  int H, W, Ho, Wo, cin, f, cout, stride, proj;
  int TH, TW, HH, HW, tiles_w, tiles, stages;  // output tile, its halo
};

// Output tile t: tile t % tiles (row-major over tiles_w) of slice
// t / tiles, its halo's origin in the image and the slice's x and out.
struct TileAt {
  int oh0, ow0, iy0, ix0;
  const bf16* xs;
  bf16* os;
  __device__ __forceinline__ TileAt(const Params& p, int t) {
    const int slice = t / p.tiles;
    const int i = t - slice * p.tiles;
    oh0 = i / p.tiles_w * p.TH;
    ow0 = i % p.tiles_w * p.TW;
    iy0 = oh0 * p.stride - 1;
    ix0 = ow0 * p.stride - 1;
    xs = p.x + static_cast<int64_t>(slice) * p.H * p.W * p.cin;
    os = p.out + static_cast<int64_t>(slice) * p.Ho * p.Wo * p.cout;
  }
};

// (a0 s[c] + b[c], a1 s[c + 1] + b[c + 1]): the affine of an accumulator
// pair, with s and b read through the read-only path (c even), which lets
// the compiler load them ahead of the epilogue's stores.
__device__ __forceinline__ float2 affine2(float a0, float a1, const float* s,
                                          const float* b, int c) {
  const float2 sc = __ldg(reinterpret_cast<const float2*>(s + c));
  const float2 bi = __ldg(reinterpret_cast<const float2*>(b + c));
  return make_float2(a0 * sc.x + bi.x, a1 * sc.y + bi.y);
}

// Lane q of each quad of lanes holds w[e], word e of row q of a 4 x 4
// matrix of words; afterwards it holds column q (w[u]: row u's word q).
// Every lane of the warp takes part.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4]) {
  const bool odd2 = threadIdx.x & 2;
  const bool odd1 = threadIdx.x & 1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {  // swap the off-diagonal 2 x 2 blocks
    const uint32_t y = __shfl_xor_sync(0xffffffffu, odd2 ? w[k] : w[k + 2], 2);
    if (odd2)
      w[k] = y;
    else
      w[k + 2] = y;
  }
#pragma unroll
  for (int k = 0; k < 4; k += 2) {  // then within each 2 x 2 block
    const uint32_t y = __shfl_xor_sync(0xffffffffu, odd1 ? w[k] : w[k + 1], 1);
    if (odd1)
      w[k] = y;
    else
      w[k + 1] = y;
  }
}

// A ring as one thread walks it: slot `stage` in phase `phase`.
struct Ring {
  uint32_t b, full, empty;  // slot 0, full[s] = full + 8 s, empty[s]
  int stages, stage;
  uint32_t phase;
  __device__ __forceinline__ void next() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// acc (N / 2 fp32 a thread) = A[the warpgroup's 64 rows, K] @ B[N, K]^T,
// B's 64-wide slabs taken from the ring in order (zero past K and past
// the matrix's rows). a_frag(kb, a, steps) fills a[kk] with the A fragments
// of slab kb's k16 steps kk < steps. One wgmma group a slab; the fragments
// of slab kb + 1 load while it runs (two register sets), and a slot is
// released (one arrival per warp) once the group reading it has retired.
template <int N, typename AFrag>
__device__ __forceinline__ void product(float* acc, Ring& ring, int K,
                                        AFrag&& a_frag) {
  const int nk = (K + BK - 1) / BK;
  const bool releaser = threadIdx.x % 32 == 0;
  uint32_t a0[4][4], a1[4][4];
  int held = -1;  // slot of the group still in flight
  auto slab = [&](int kb, uint32_t(&a)[4][4]) {
    const int steps = min(4, (K - kb * BK + 15) / 16);
    a_frag(kb, a, steps);
    mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    wgmma_fence();
    const uint32_t b = ring.b + ring.stage * B_STAGE_BYTES;
    if (steps == 4) {  // a whole slab: four wgmma back to back
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_m64k16<N>(acc, a[kk], sw128_desc(b + kk * 32),
                           (kb | kk) != 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < steps)
          wgmma_rs_m64k16<N>(acc, a[kk], sw128_desc(b + kk * 32),
                             (kb | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (held >= 0 && releaser) mbar_arrive(ring.empty + 8 * held);
    held = ring.stage;
    ring.next();
  };
  fence_operands<N / 2>(acc);
  for (int kb = 0; kb < nk; kb += 2) {
    slab(kb, a0);
    if (kb + 1 < nk) slab(kb + 1, a1);
  }
  wgmma_wait<0>();
  fence_operands<N / 2>(acc);
  if (releaser) mbar_arrive(ring.empty + 8 * held);
}

// The A fragments of a gathered slab (conv1's halo rows, the projection's
// rows) for this warp's 16 rows of the warpgroup's 64: wait for the slot,
// ldmatrix (row r of a slot at 128 r bytes, its 16-byte chunk c at
// c ^ (r % 8): conflict-free), release the slot at once (the fragments
// are in registers).
template <int NWG>
__device__ __forceinline__ void take_gathered(Ring& ar, int first_row,
                                              uint32_t (&a)[4][4],
                                              int steps) {
  const int lane = threadIdx.x % 32;
  mbar_wait(ar.full + 8 * ar.stage, ar.phase);
  const uint32_t src = ar.b + ar.stage * NWG * A_SLOT_BYTES +
                       (first_row + (lane & 15)) * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < steps)
      ldmatrix_x4(a[kk], src + (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4));
  __syncwarp();
  if (lane == 0) mbar_arrive(ar.empty + 8 * ar.stage);
  ar.next();
}

template <int NF, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), NWG == 1 ? 2 : 1)
    fused_block_kernel(const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w2,
                       const __grid_constant__ CUtensorMap map_w3,
                       const __grid_constant__ CUtensorMap map_wp,
                       const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int P = p.TH * p.TW;   // output pixels of the tile
  const int P1 = p.HH * p.HW;  // halo pixels of y1
  const Layout L = layout(p.f, NWG, p.stages, P1);
  Ring ring;  // weight slabs
  ring.b = base;
  ring.full = base + L.bar;
  ring.empty = ring.full + 8 * p.stages;
  ring.stages = p.stages;
  ring.stage = 0;
  ring.phase = 0;
  Ring ar;  // gathered A slabs
  ar.b = base + L.a;
  ar.full = ring.empty + 8 * p.stages;
  ar.empty = ar.full + 8 * A_STAGES;
  ar.stages = A_STAGES;
  ar.stage = 0;
  ar.phase = 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 4 * NWG);  // one arrival per warp
    }
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(ar.full + 8 * s, GATHER_THREADS);
      mbar_init(ar.empty + 8 * s, 4 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int s = p.stride;
  const int groups = (P1 + BM * NWG - 1) / (BM * NWG);  // conv1 row groups
  const TileAt T(p, blockIdx.x);

  if (warp < 4) {
    setmaxnreg_dec<40>();
    if (warp == 0 && lane == 0) {
      // ---- every weight slab, in the consumers' order ------------------ //
      auto put = [&](const CUtensorMap* map, int K, int n0, int rows) {
        for (int k0 = 0; k0 < K; k0 += BK) {
          mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1);
          const uint32_t bar = ring.full + 8 * ring.stage;
          mbar_arrive_expect_tx(bar, rows * BK * 2);
          tma_load_2d(ring.b + ring.stage * B_STAGE_BYTES, map, k0, n0, bar);
          ring.next();
        }
      };
      for (int g = 0; g < groups; ++g) put(&map_w1, p.cin, 0, NF);
      put(&map_w2, 9 * p.f, 0, NF);
      for (int n0 = 0; n0 < p.cout; n0 += BN3) {
        put(&map_w3, p.f, n0, BN3);
        if (p.proj) put(&map_wp, p.cin, n0, BN3);
      }
    } else if (warp == 1 || warp == 2) {
      // ---- every x row conv1 and the projection read, in their order:
      // thread t copies 16-byte chunk t % 8 of rows t / 8 + 8 i of a slot
      const int t = threadIdx.x - 32;
      const int c = t % 8;
      int offs[8 * NWG];  // element offsets of the rows in the slice; -1: 0
      auto fill = [&]() {
        for (int k0 = 0; k0 < p.cin; k0 += BK) {
          mbar_wait(ar.empty + 8 * ar.stage, ar.phase ^ 1);
          const int k = k0 + c * 8;
          const uint32_t slot = ar.b + ar.stage * NWG * A_SLOT_BYTES;
#pragma unroll
          for (int i = 0; i < 8 * NWG; ++i) {
            const int r = t / 8 + 8 * i;  // r % 8 == t / 8
            const bool valid = offs[i] >= 0 && k < p.cin;  // cin % 8 == 0
            cp_async16(slot + r * 128 + ((c ^ (t / 8)) << 4),
                       valid ? T.xs + offs[i] + k : p.x, valid);
          }
          cp_async_arrive(ar.full + 8 * ar.stage);
          ar.next();
        }
      };
      for (int grp = 0; grp < groups; ++grp) {
#pragma unroll
        for (int i = 0; i < 8 * NWG; ++i) {
          const int q = grp * BM * NWG + t / 8 + 8 * i;  // halo pixel
          const int hy = q / p.HW;
          const int iy = T.iy0 + hy;
          const int ix = T.ix0 + q - hy * p.HW;
          offs[i] = (q < P1 && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
                        ? (iy * p.W + ix) * p.cin
                        : -1;
        }
        fill();
      }
      if (p.proj) {  // x[::s, ::s] at the tile's output pixels
#pragma unroll
        for (int i = 0; i < 8 * NWG; ++i) {
          const int r = t / 8 + 8 * i;
          const int oh = T.oh0 + r / p.TW;
          const int ow = T.ow0 + r % p.TW;
          offs[i] = (r < P && oh < p.Ho && ow < p.Wo)
                        ? (oh * s * p.W + ow * s) * p.cin
                        : -1;
        }
        for (int n0 = 0; n0 < p.cout; n0 += BN3) fill();
      }
    }
  } else {
    setmaxnreg_inc<NWG == 1 ? 216 : 232>();
    const int wg = warp / 4 - 1;  // consumer warpgroup
    const int wr = warp % 4 * 16;  // this warp's first row of the 64
    const int g = lane / 4;       // accumulator rows g, g + 8
    const int t2 = lane % 4 * 2;  // accumulator columns t2, t2 + 1 of each 8
    const int ldf = p.f + 8;      // padded y1/y2 row: an odd number of 16 B
    auto gathered = [&](int, uint32_t(&a)[4][4], int steps) {
      take_gathered<NWG>(ar, wg * BM + wr, a, steps);
    };

    const uint32_t y = base + L.y;  // y1, then y2 over it
    bf16* ys = reinterpret_cast<bf16*>(smem_raw + (y - raw));

    // ---- A. conv1 + affine + ReLU on the halo -> y1 ------------------- //
    for (int grp = 0; grp < groups; ++grp) {
      const int m0 = (grp * NWG + wg) * BM + wr;  // this warp's first row
      float acc[NF / 2];
      product<NF>(acc, ring, p.cin, gathered);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = m0 + g + 8 * h;
        if (q >= P1) continue;
        const int hy = q / p.HW;
        const int iy = T.iy0 + hy;
        const int ix = T.ix0 + q - hy * p.HW;
        const bool inside = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
#pragma unroll
        for (int j = 0; j < NF / 8; ++j) {
          const int col = 8 * j + t2;
          if (col >= p.f) continue;
          float2 v = make_float2(0.f, 0.f);  // the 3x3 conv's zero padding
          if (inside)
            v = affine2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], p.s1, p.b1,
                        col);
          *reinterpret_cast<__nv_bfloat162*>(ys + q * ldf + col) =
              __floats2bfloat162_rn(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
        }
      }
    }
    named_barrier_sync(1, 128 * NWG);  // y1 whole

    // ---- B. 3x3 conv (implicit im2col from y1) + affine + ReLU -> y2 - //
    const int rw = wg * BM + wr;  // this warp's first output pixel
    {
      const int r = rw + (lane & 15);  // this lane's ldmatrix row
      int q0 = 0;                      // padding rows read y1 row 0
      if (r < P) {
        const int i = r / p.TW;
        q0 = i * s * p.HW + (r - i * p.TW) * s;
      }
      const int f = p.f;
      const int HW = p.HW;
      const int c8 = (lane >> 4) * 8;
      float acc[NF / 2];
      // y1 address of this lane's A row at column k of the im2col matrix
      auto tap_row = [&](int k) {
        const int tap = k / f;
        const int dh = tap / 3;
        const int q = q0 + dh * HW + (tap - 3 * dh);
        return y + static_cast<uint32_t>((q * ldf + k - tap * f) * 2);
      };
      product<NF>(acc, ring, 9 * f,
                  [&](int kb, uint32_t(&a)[4][4], int steps) {
                    if (f % BK == 0) {  // the slab lies within one tap
                      const uint32_t src = tap_row(kb * BK + c8);
#pragma unroll
                      for (int kk = 0; kk < 4; ++kk)
                        ldmatrix_x4(a[kk], src + kk * 32);
                    } else {
#pragma unroll
                      for (int kk = 0; kk < 4; ++kk)
                        if (kk < steps)
                          ldmatrix_x4(a[kk], tap_row(kb * BK + kk * 16 + c8));
                    }
                  });
      named_barrier_sync(1, 128 * NWG);  // every warp is done with y1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rw + g + 8 * h;
#pragma unroll
        for (int j = 0; j < NF / 8; ++j) {
          const int col = 8 * j + t2;
          if (col >= f) continue;
          const float2 v = affine2(acc[4 * j + 2 * h],
                                   acc[4 * j + 2 * h + 1], p.s2, p.b2, col);
          *reinterpret_cast<__nv_bfloat162*>(ys + row * ldf + col) =
              __floats2bfloat162_rn(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
        }
      }
      __syncwarp();  // a warp reads back only its own 16 rows of y2
    }

    // ---- C. conv3 + affine (+ projection) + residual + ReLU -> out ----- //
    const uint32_t y2_row =
        y + static_cast<uint32_t>(((rw + (lane & 15)) * ldf +
                                   (lane >> 4) * 8) * 2);
    auto conv3 = [&](float* acc) {
      product<BN3>(acc, ring, p.f, [&](int kb, uint32_t(&a)[4][4], int steps) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < steps) ldmatrix_x4(a[kk], y2_row + (kb * BK + kk * 16) * 2);
      });
    };
    if (p.proj) {
      // block 0: the projection's x rows come through the gather ring, and
      // the epilogue stores from the accumulators, each quad of lanes
      // trading words so that a lane writes 16 bytes of a row
      for (int n0 = 0; n0 < p.cout; n0 += BN3) {
        float acc[BN3 / 2];
        float accp[BN3 / 2];
        conv3(acc);
        product<BN3>(accp, ring, p.cin, gathered);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + g + 8 * h;
          const int oh = T.oh0 + r / p.TW;
          const int ow = T.ow0 + r % p.TW;
          const bool row_in = r < P && oh < p.Ho && ow < p.Wo;
          bf16* o = T.os + (oh * p.Wo + ow) * p.cout;
#pragma unroll
          for (int m = 0; m < BN3 / 32; ++m) {  // columns n0 + 32 m ..
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 4 * m + e;
              const int col = n0 + 8 * j + t2;
              const int c = col < p.cout ? col : 0;  // reads stay inside
              const float2 v = affine2(acc[4 * j + 2 * h],
                                       acc[4 * j + 2 * h + 1], p.s3, p.b3, c);
              const float2 u = affine2(accp[4 * j + 2 * h],
                                       accp[4 * j + 2 * h + 1], p.sp, p.bp, c);
              const __nv_bfloat162 b = __floats2bfloat162_rn(
                  fmaxf(v.x + u.x, 0.f), fmaxf(v.y + u.y, 0.f));
              w[e] = *reinterpret_cast<const uint32_t*>(&b);
            }
            quad_transpose(w);
            const int col = n0 + 32 * m + 8 * (lane % 4);
            if (row_in && col < p.cout)
              *reinterpret_cast<uint4*>(o + col) =
                  make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
    } else {
      // The residual (x: stride 1, Cin == Cout) and the output pass through
      // this warp's 16 rows x 128 columns of the gather ring, idle once
      // conv1 is done, in 16-byte coalesced copies (chunks XOR-swizzled by
      // row): the residual lands while conv3 multiplies, the epilogue adds
      // it in place, the rows go out whole.
      const uint32_t st = base + L.a + (warp - 4) * STAGE_WARP_BYTES;
      uint8_t* stg = smem_raw + (st - raw);
      auto chunk_at = [](int row, int c) {
        return row * 256 + ((c ^ (row & 7)) << 4);
      };
      const int c = lane % 16;  // this lane's 16-byte chunk of its copy rows
      for (int n0 = 0; n0 < p.cout; n0 += BN3) {
        const bool cin_chunk = n0 + c * 8 < p.cout;
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // rows lane / 16 + 2 i of the warp's
          const int row = lane / 16 + 2 * i;
          const int r = rw + row;
          const int oh = T.oh0 + r / p.TW;
          const int ow = T.ow0 + r % p.TW;
          const bool valid = cin_chunk && r < P && oh < p.Ho && ow < p.Wo;
          cp_async16(st + chunk_at(row, c),
                     valid ? T.xs + (oh * p.W + ow) * p.cin + n0 + c * 8 : p.x,
                     valid);
        }
        float acc[BN3 / 2];
        conv3(acc);
        cp_async_wait_all();
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = g + 8 * h;
#pragma unroll
          for (int j = 0; j < BN3 / 8; ++j) {
            const int col = n0 + 8 * j + t2;
            if (col >= p.cout) continue;
            __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(
                stg + chunk_at(row, j) + t2 * 2);
            const float2 v = affine2(acc[4 * j + 2 * h],
                                     acc[4 * j + 2 * h + 1], p.s3, p.b3, col);
            const float2 res = __bfloat1622float2(*e);
            *e = __floats2bfloat162_rn(fmaxf(v.x + res.x, 0.f),
                                       fmaxf(v.y + res.y, 0.f));
          }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = lane / 16 + 2 * i;
          const int r = rw + row;
          const int oh = T.oh0 + r / p.TW;
          const int ow = T.ow0 + r % p.TW;
          if (cin_chunk && r < P && oh < p.Ho && ow < p.Wo)
            *reinterpret_cast<uint4*>(T.os + (oh * p.Wo + ow) * p.cout + n0 +
                                      c * 8) =
                *reinterpret_cast<const uint4*>(stg + chunk_at(row, c));
        }
        __syncwarp();  // the rows are read out before the next residual
      }
    }
  }
}

// Blocks of the kernel an SM holds with `smem` bytes of dynamic shared
// memory (the occupancy query); minus the CUDA error on failure.
template <int NF, int NWG>
int occupancy(int smem) {
  auto kernel = fused_block_kernel<NF, NWG>;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, 128 * (NWG + 1), smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// One block per output tile of every slice.
template <int NF, int NWG>
cudaError_t launch(const CUtensorMap* maps, const Params& p, int blocks,
                   int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel<NF, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_block_kernel<NF, NWG><<<blocks, 128 * (NWG + 1), smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

}  // namespace

// Dynamic shared memory of one block under a plan (stage_fused.plan).
extern "C" int avtex_fused_block_smem(int f, int warpgroups, int b_stages,
                                      int halo_rows) {
  return layout(f, warpgroups, b_stages, halo_rows).bytes;
}

// Blocks an SM holds of the kernel for width f with `warpgroups` consumer
// warpgroups and `smem` bytes of dynamic shared memory (the occupancy
// query); minus the CUDA error on failure.
extern "C" int avtex_fused_block_ctas_per_sm(int f, int warpgroups,
                                             int smem) {
  const bool wide = f > 64;
  if (warpgroups == 1) return wide ? occupancy<128, 1>(smem)
                                   : occupancy<64, 1>(smem);
  return wide ? occupancy<128, 2>(smem) : occupancy<64, 2>(smem);
}

// Plain C launcher for ctypes: one bottleneck on x [bt, H, W, cin] ->
// out [bt, H/stride, W/stride, cout] under the plan (th x tw output tiles,
// `warpgroups` consumer warpgroups, a weight ring of `b_stages` slots).
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success). wp, sp and bp are null for a block without a projection.
// Shapes or a plan the kernel does not take give cudaErrorInvalidValue
// (the Python wrapper raises on the shapes first).
extern "C" int avtex_fused_block(
    const void* x, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, const void* w3,
    const void* s3, const void* b3, const void* wp, const void* sp,
    const void* bp, void* out, int bt, int H, int W, int cin, int f, int cout,
    int stride, int th, int tw, int warpgroups, int b_stages, void* stream) {
  const bool proj = wp != nullptr;
  const int Ho = stride > 0 ? H / stride : 0;
  const int Wo = stride > 0 ? W / stride : 0;
  bool ok = bt > 0 && H > 0 && W > 0 && cin > 0 && cin % 8 == 0 && f > 0 &&
            f % 16 == 0 && f <= MAX_F && cout > 0 && cout % 16 == 0 &&
            (stride == 1 || stride == 2) &&
            (stride == 1 || (H % 2 == 0 && W % 2 == 0)) &&
            (proj || (stride == 1 && cin == cout)) &&
            (!proj || (sp != nullptr && bp != nullptr)) && aligned16(x) &&
            aligned16(w1) && aligned16(w2) && aligned16(w3) &&
            aligned16(wp) && aligned16(out) && aligned8(s1) && aligned8(b1) &&
            aligned8(s2) && aligned8(b2) && aligned8(s3) && aligned8(b3) &&
            aligned8(sp) && aligned8(bp) &&
            static_cast<int64_t>(H) * W * cin < (1LL << 31) &&
            static_cast<int64_t>(Ho) * Wo * cout < (1LL << 31);
  // the plan: a tile inside the output that one block's rows cover
  ok = ok && (warpgroups == 1 || warpgroups == 2) && b_stages >= 2 &&
       b_stages <= MAX_B_STAGES && th >= 1 && tw >= 1 && th <= Ho && tw <= Wo &&
       th * tw <= BM * warpgroups;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.x = static_cast<const bf16*>(x);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.s3 = static_cast<const float*>(s3);
  p.b3 = static_cast<const float*>(b3);
  p.sp = static_cast<const float*>(sp);
  p.bp = static_cast<const float*>(bp);
  p.out = static_cast<bf16*>(out);
  p.H = H;
  p.W = W;
  p.Ho = Ho;
  p.Wo = Wo;
  p.cin = cin;
  p.f = f;
  p.cout = cout;
  p.stride = stride;
  p.proj = proj;
  p.TH = th;
  p.TW = tw;
  p.HH = (th - 1) * stride + 3;
  p.HW = (tw - 1) * stride + 3;
  p.tiles_w = (Wo + tw - 1) / tw;
  p.tiles = ((Ho + th - 1) / th) * p.tiles_w;
  p.stages = b_stages;
  const int64_t total = static_cast<int64_t>(bt) * p.tiles;
  const int smem = layout(f, warpgroups, b_stages, p.HH * p.HW).bytes;
  if (total > 0x7fffffffLL || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(total);

  // Weight maps in 64-k boxes: w1 and w2 (N = F) as wide as the product
  // (64 or 128 rows), w3 and wp (N = Cout) in 128-row chunks.
  const int nf = f > 64 ? 128 : 64;
  CUtensorMap maps[4];
  if (!bf16_map_2d(&maps[0], w1, cin, f, BK, nf) ||
      !bf16_map_2d(&maps[1], w2, 9 * f, f, BK, nf) ||
      !bf16_map_2d(&maps[2], w3, f, cout, BK, BN3) ||
      !bf16_map_2d(&maps[3], proj ? wp : w3, proj ? cin : f, cout, BK, BN3))
    return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (warpgroups == 1)
    err = nf == 64 ? launch<64, 1>(maps, p, blocks, smem, st)
                   : launch<128, 1>(maps, p, blocks, smem, st);
  else
    err = nf == 64 ? launch<64, 2>(maps, p, blocks, smem, st)
                   : launch<128, 2>(maps, p, blocks, smem, st);
  return static_cast<int>(err);
}
