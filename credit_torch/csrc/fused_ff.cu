// Fused feed-forward with its residual, in the two forms of the TPU kernel:
//   pre-norm (CrossFormer):  x + fc2(GELU(fc1(LN(x))))
//   post-norm (SwinV2/FuXi): x + LN(fc2(GELU(fc1(x))))
//
// Replaces credit_tpu/ops/pallas_ff.py fused_ff (_ff_kernel at :58, the
// pallas_calls at :516 and :538), both forms. Every transformer FF of the
// flagship runs through the pre-norm form (28 calls per rollout step at
// C = 128..1024, hidden = 4C); every SwinV2 MLP of FuXi through the
// post-norm form (16 calls per step at C = 1024, M = 16905 tokens).
//
// Bound on the H100: operations. Each row does 4*C*H flops (H = 4C) against
// a few bytes of x and out, far above the card's ~295 FLOP/byte ridge once
// the hidden activations stay cheap to move.
//
// Two bf16 designs, picked per shape by cuda_ff.ff_plan:
//
// Fused (C <= 256, C % 8 == 0; fused_ff_wgmma): the 4C-wide hidden layer
// never leaves the SM, nor even its registers. Persistent blocks walk row
// tiles; a producer warp feeds TMA loads of each tile's x and of w1 / w2 in
// chunks of 64 hidden columns through an mbarrier ring (tma_gemm.cuh's
// scheme), and consumer warpgroups of 64 rows each run, per chunk:
//   h = y . w1[:, chunk]            wgmma, A = y from shared memory, f32
//   + b1, exact GELU (erff), cast   in registers
//   acc += h . w2[chunk, :]         wgmma with A from registers (WgmmaRS)
// y = LN(x) (pre-norm: f32 statistics, cast to bf16, into a swizzled tile
// beside x) or x itself (post-norm). fc2 of a chunk is in flight while the
// next chunk's GELU runs, and the other warpgroups' products fill the
// gaps. After the last chunk: + b2 in f32, post-norm the LN of each f32 row
// over the true C (a row's columns sit in one quad of lanes: two shuffles,
// no shared memory), the cast, + x in bf16 from the staged tile, and a TMA
// store -- the rounding points of the TPU kernel (pallas_ff.py:68-79).
// What bounds it is the GELU: erff compiles branch-free, each term's
// coefficient selected per value, and at the WXFormer's stage 0 (C = 128,
// hidden 512: 147 M hidden values) the kernel without its GELU takes half
// the time, while the 256 KB of weights each tile reads again from L2 cost
// ~2%. The GELU and the products do not overlap: as much erff work on
// values no product gives, issued while the products are in flight, costs
// as much again (tools/ff_probe.py on one H100 80GB HBM3 at 700 W,
// PERF.md). An earlier mma.sync design (16 warps in step, each
// chunk's GELU through shared memory behind a block barrier) read 0.80 ms
// at stage 0 on that card, this one 0.33.
//
// Split (C > 256, C % 8 != 0): LN rows, then fc1 and fc2 as two
// warp-specialised TMA + wgmma GEMMs (tma_gemm.cuh, the VALID conv's
// mainloop) whose epilogues add the biases, apply GELU, round and add the
// residual; the 4C-wide hidden goes to device memory once, in bf16 (138 MB
// for FuXi's 16,905 rows), and both products run at wgmma's rate. Post-norm
// writes fc2's f32 output and a row pass takes its LN. See "bf16, split".
//
// Padded columns (zero-filled by TMA in the fused kernel, zero-padded to a
// multiple of 8 by the split route's wrapper) are zero before the post-norm
// LN, which leaves them out of its statistics. f32 is plain FMA, 16 rows per
// block, accumulators in registers (C <= 1024); wider or ragged f32 widths
// run the same function in passes (credit_fused_ff_passes in
// fused_ff_bwd.cu).
#include "ff_rows.cuh"
#include "tma_gemm.cuh"

namespace credit {
namespace ff {

constexpr int THREADS_F32 = 256;  // the f32 kernel's block
constexpr int WARPS_F32 = THREADS_F32 / 32;
constexpr int MAX_C = 1024;

__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// LN(x) rows [m0, m0+BM) into y (input dtype, row stride ldy, zero-filled
// past C and past M). One warp per row, f32 statistics.
template <typename T>
__device__ void layer_norm_rows(const T* __restrict__ x, const T* __restrict__ gam,
                                const T* __restrict__ bet, T* y, int ldy, int m0, int bm, int m,
                                int c, int cpad) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < bm; r += WARPS_F32) {
    T* yr = y + r * ldy;
    if (m0 + r >= m) {
      for (int k = lane; k < cpad; k += 32) yr[k] = from_f32<T>(0.f);
      continue;
    }
    const T* xr = x + (size_t)(m0 + r) * c;
    float s = 0.f;
    for (int k = lane; k < c; k += 32) s += to_f32(xr[k]);
    const float mean = warp_sum(s) / c;
    float v = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float d = to_f32(xr[k]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / c + kEps);
    for (int k = lane; k < cpad; k += 32)
      yr[k] = k < c ? from_f32<T>((to_f32(xr[k]) - mean) * rstd * to_f32(gam[k]) + to_f32(bet[k]))
                    : from_f32<T>(0.f);
  }
}

// x rows [m0, m0+BM) into y as they are (post-norm: fc1 reads x), zero past M.
template <typename T>
__device__ void copy_rows(const T* __restrict__ x, T* y, int m0, int bm, int m, int c) {
  for (int i = threadIdx.x; i < bm * c; i += blockDim.x) {
    const int r = i / c;
    y[i] = m0 + r < m ? x[(size_t)m0 * c + i] : from_f32<T>(0.f);
  }
}

// ---------------------------------------------------------------- bf16, fused
// A persistent block walks row tiles: a producer warpgroup (one thread
// issues TMA) and consumer warpgroups of 64 rows each, three (ROWS = 192)
// up to CP = 128 and two (ROWS = 128) at 256. Every operand stays at its
// own width: TMA zero-fills each tile to CP = 64, 128 or 256 columns and
// the hidden width to chunks of HC = 64 (and clips the stores past c and
// m), and the bias and LN vectors are read only below c and hidden. Shared memory: XS slots of the x tile
// (CP / 64 boxes of ROWS rows x 64 columns, 128-byte swizzled, K-major: fc1's
// A in post-norm form and the residual's source), pre-norm the y = LN(x)
// tile in the same layout, and a ring of weight stages, each one chunk of
// w1 (CP x 64) or of w2 (64 x CP) as CP / 64 MN-major 64 x 64 boxes. A
// tile's 2n ring items (n chunks) come in the order w1(0), w1(1), w2(0),
// w1(2), w2(1), ..., w2(n-1): the order in which the consumers take them.
namespace fused {

constexpr int HC = 64;  // hidden columns a chunk

// consumer warpgroups (64 rows each) at width CP: three where their
// registers fit (acc CP / 2, h 32 and a 16 beside the addresses, in 160),
// two at CP = 256
__host__ __device__ constexpr int warpgroups(int cp) { return cp <= 128 ? 3 : 2; }

template <int CP, bool POST>
struct Layout {
  static_assert(CP == 64 || CP == 128 || CP == 256, "CP: 64, 128 or 256");
  static constexpr int NWG = warpgroups(CP);
  static constexpr int ROWS = 64 * NWG;              // rows a tile
  static constexpr int THREADS = 128 * (NWG + 1);    // the producer warpgroup first
  // registers a producer and a consumer thread keep by setmaxnreg: all the
  // SM's 65,536 at three consumer warpgroups
  static constexpr int PRODUCER_REGS = NWG == 3 ? 32 : 40, REGS = NWG == 3 ? 160 : 232;
  static constexpr int X_BOX = ROWS * 128;           // one 64-column box of a row tile
  static constexpr int KB = CP / 64;                 // 64-column boxes a row
  static constexpr int X = KB * X_BOX;               // one row tile
  static constexpr int Y = POST ? 0 : X;
  static constexpr int STAGE = KB * tma::BOX_BYTES;  // one chunk of w1 or of w2
  static constexpr int FIXED = 1024 + Y + 256;       // alignment slack, y, barriers
  // two x slots where three stages still fit beside them: the next tile's x
  // lands during this tile's products
  static constexpr int XS = FIXED + 2 * X + 3 * STAGE <= kMaxSmem ? 2 : 1;
  static constexpr int FIT = (kMaxSmem - FIXED - XS * X) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t SMEM = (size_t)FIXED + XS * X + STAGES * STAGE;
  static_assert(STAGES >= 3, "a warpgroup holds two stages, and one is loading");
};

// item i of a tile's ring: true for w2, with its chunk in j
__device__ __forceinline__ bool ring_item(int i, int n, int& j) {
  const bool w2 = i == 2 * n - 1 || (i > 0 && i % 2 == 0);
  j = i == 2 * n - 1 ? n - 1 : w2 ? i / 2 - 1 : (i + 1) / 2;
  return w2;
}

// byte offset of (row r, 8-column group v) in a row tile of 64-column boxes
// of x_box bytes, 128-byte swizzled
__device__ __forceinline__ int tile_offset(int r, int v, int x_box) {
  return (v / 8) * x_box + r * 128 + (((v % 8) ^ (r % 8)) << 4);
}

// LN of the warpgroup's 64 rows of the x tile into the y tile, f32
// statistics over the true c (columns past c are zero and stay so): G lanes
// a row, VPL 16-byte vectors each (vectors sub, sub + G, ...: the rows of a
// warp read every bank evenly), 64 / (4 RPW) passes of RPW rows a warp
template <int CP, int X_BOX>
__device__ __forceinline__ void layer_norm_tile(const unsigned char* xt, unsigned char* yt,
                                                const __nv_bfloat16* __restrict__ gam,
                                                const __nv_bfloat16* __restrict__ bet, int c,
                                                int cw, int wt) {
  constexpr int VPL = CP / 32 < 4 ? CP / 32 : 4, G = CP / 8 / VPL, RPW = 32 / G;
  const int warp = wt / 32, lane = wt % 32, sub = lane % G;
  const float inv_c = 1.f / c;
  float g[VPL][8], b[VPL][8];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = sub + G * i;
    const bool in = 8 * v < c;  // c % 8 == 0: a vector is in or out whole
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const uint4 graw = in ? *reinterpret_cast<const uint4*>(gam + 8 * v) : zero;
    const uint4 braw = in ? *reinterpret_cast<const uint4*>(bet + 8 * v) : zero;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      g[i][k] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&graw)[k]);
      b[i][k] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&braw)[k]);
    }
  }
#pragma unroll
  for (int pass = 0; pass < 64 / (4 * RPW); ++pass) {
    const int r = cw * 64 + (pass * 4 + warp) * RPW + lane / G;
    float f[VPL][8], sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xt + tile_offset(r, sub + G * i, X_BOX));
#pragma unroll
      for (int k = 0; k < 8; ++k)
        sum += f[i][k] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&raw)[k]);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum * inv_c;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (8 * (sub + G * i) < c)
#pragma unroll
        for (int k = 0; k < 8; ++k) var += (f[i][k] - mean) * (f[i][k] - mean);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
    const float rstd = rsqrtf(var * inv_c + kEps);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      uint4 out;
#pragma unroll
      for (int k = 0; k < 8; k += 2)
        reinterpret_cast<uint32_t*>(&out)[k / 2] =
            pack_bf16((f[i][k] - mean) * rstd * g[i][k] + b[i][k],
                      (f[i][k + 1] - mean) * rstd * g[i][k + 1] + b[i][k + 1]);
      *reinterpret_cast<uint4*>(yt + tile_offset(r, sub + G * i, X_BOX)) = out;
    }
  }
}

// x, out: (m, c) row tiles (load boxes of ROWS rows, store boxes of 64); w1
// (c, hidden), w2 (hidden, c): 64 x 64 boxes; gam, bet, b2 (c,), b1
// (hidden,); c <= CP, hidden % 8 == 0
template <int CP, bool POST>
__global__ void __launch_bounds__(Layout<CP, POST>::THREADS, 1)
fused_ff_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tout,
               const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap tw2,
               const __nv_bfloat16* __restrict__ gam, const __nv_bfloat16* __restrict__ bet,
               const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ b2, int m,
               int c, int hidden) {
  using L = Layout<CP, POST>;
  constexpr int S = L::STAGES, ROWS = L::ROWS, X_BOX = L::X_BOX;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* xs = align1024(smem_raw);
  unsigned char* ys = xs + L::XS * L::X;
  unsigned char* ring = ys + L::Y;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * L::STAGE);
  uint64_t* empty = full + S;
  uint64_t* xfull = empty + S;
  uint64_t* xempty = xfull + L::XS;
  const int tiles = (m + ROWS - 1) / ROWS, chunks = (hidden + HC - 1) / HC, items = 2 * chunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * L::NWG);  // one arrival per consumer warp
    }
    for (int s = 0; s < L::XS; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], L::NWG);  // one per consumer warpgroup, once its stores have read it
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    reg_dealloc<L::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int p = 0;  // ring items issued
      for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
        const int xsl = it % L::XS;
        mbar_wait(&xempty[xsl], ((it / L::XS) & 1) ^ 1);
        mbar_expect_tx(&xfull[xsl], L::X);
#pragma unroll
        for (int kb = 0; kb < L::KB; ++kb)
          tma_load_2d(xs + xsl * L::X + kb * X_BOX, &tx, &xfull[xsl], 64 * kb, t * ROWS);
        for (int i = 0; i < items; ++i, ++p) {
          const int s = p % S;
          mbar_wait(&empty[s], ((p / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], L::STAGE);
          unsigned char* st = ring + s * L::STAGE;
          int j;
          if (ring_item(i, chunks, j)) {
#pragma unroll
            for (int b = 0; b < L::KB; ++b)
              tma_load_2d(st + b * tma::BOX_BYTES, &tw2, &full[s], 64 * b, HC * j);
          } else {
#pragma unroll
            for (int b = 0; b < L::KB; ++b)
              tma_load_2d(st + b * tma::BOX_BYTES, &tw1, &full[s], HC * j, 64 * b);
          }
        }
      }
    }
  } else {  // the consumers
    reg_alloc<L::REGS>();
    const int cw = threadIdx.x / 128 - 1, wt = threadIdx.x % 128;
    const int warp = wt / 32, lane = wt % 32, q = lane % 4;
    int got = 0, freed = 0;  // ring items waited for and freed
    for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
      const int xsl = it % L::XS;
      unsigned char* xt = xs + xsl * L::X;
      mbar_wait(&xfull[xsl], (it / L::XS) & 1);
      if constexpr (!POST) {
        layer_norm_tile<CP, X_BOX>(xt, ys, gam, bet, c, cw, wt);
        fence_proxy_async();  // y's generic writes, before wgmma reads them
        named_sync(1 + cw, 128);
      }
      // fc1's A: the warpgroup's 64 rows of y (pre-norm) or x, K-major
      const uint32_t a_base = smem_u32(POST ? xt : ys) + cw * tma::BOX_BYTES;

      // the ring is consumed and freed in its order
      auto stage = [&]() {
        const int g = got++;
        mbar_wait(&full[g % S], (g / S) & 1);
        return smem_u32(ring + (g % S) * L::STAGE);
      };
      auto release = [&]() {
        if (lane == 0) mbar_arrive(&empty[freed % S]);
        ++freed;
      };
      // h = A . w1[:, chunk], into f32 accumulators
      auto fc1 = [&](float (&h)[32]) {
#pragma unroll
        for (int i = 0; i < 32; ++i) h[i] = 0.f;
        const uint32_t st = stage();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CP / 16; ++kk)
          Wgmma<64>::run<0, 1>(h, desc_sw128(a_base + (kk / 4) * X_BOX + (kk % 4) * 32, 16, 1024),
                               desc_sw128(st + kk * 2048, tma::BOX_BYTES, 1024));
        wgmma_commit();
      };
      // h = GELU(h + b1) of chunk j, in place (hidden columns past `hidden`
      // are zero: no bias)
      auto activate = [&](float (&h)[32], int j) {
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int col = HC * j + 8 * n8 + 2 * q;  // hidden % 8 == 0: col + 1 too
          const float2 bb = col < hidden ? __bfloat1622float2(*reinterpret_cast<
                                               const __nv_bfloat162*>(b1 + col))
                                         : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 4; ++e) h[4 * n8 + e] = gelu(h[4 * n8 + e] + (e % 2 ? bb.y : bb.x));
        }
      };
      // bf16 pairs of h as fc2's A fragments
      auto pack = [&](const float (&h)[32], uint32_t (&a)[16]) {
#pragma unroll
        for (int i = 0; i < 16; ++i) a[i] = pack_bf16(h[2 * i], h[2 * i + 1]);
      };
      float acc[CP / 2];
#pragma unroll
      for (int i = 0; i < CP / 2; ++i) acc[i] = 0.f;
      // acc += a . w2[chunk, :]
      auto fc2 = [&](const uint32_t (&a)[16]) {
        const uint32_t st = stage();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaRS<CP>::template run<1>(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                                       a[4 * kk + 3],
                                       desc_sw128(st + kk * 2048, tma::BOX_BYTES, 1024));
        wgmma_commit();
      };

      // Chunk by chunk, the products of chunk j + 1's fc1 and chunk j's fc2
      // go out together; the first is waited for, and its GELU runs while
      // the second is in flight. Every wait retires products issued in the
      // same iteration, which lets ptxas keep the wgmmas asynchronous.
      float h[32];
      uint32_t a[16];
      fc1(h);
      wgmma_wait<0>();
      fence_regs(h);
      release();
      activate(h, 0);
      pack(h, a);
#pragma unroll 1
      for (int j = 0; j + 1 < chunks; ++j) {
        fc1(h);
        fc2(a);
        wgmma_wait<1>();
        fence_regs(h);
        release();
        activate(h, j + 1);
        wgmma_wait<0>();
        release();
        pack(h, a);
      }
      fc2(a);
      wgmma_wait<0>();
      fence_regs(acc);
      release();

      // + b2 in f32; post-norm: the LN of each f32 row, whose CP columns
      // sit in one quad of lanes (thread: rows r and r + 8, columns 8 n8 +
      // 2 q + {0, 1}), over the true c. c % 8 == 0: an n8 tile is in or out
      // whole, and the columns past c are zero and never stored.
      auto pair = [&](const __nv_bfloat16* v, int n8) {
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + 8 * n8 + 2 * q));
      };
#pragma unroll
      for (int n8 = 0; n8 < CP / 8; ++n8)
        if (8 * n8 < c) {
          const float2 bb = pair(b2, n8);
#pragma unroll
          for (int h = 0; h < 2; ++h) acc[4 * n8 + 2 * h] += bb.x, acc[4 * n8 + 2 * h + 1] += bb.y;
        }
      if constexpr (POST) {
        float mean[2] = {0.f, 0.f}, var[2] = {0.f, 0.f};
#pragma unroll
        for (int n8 = 0; n8 < CP / 8; ++n8)
          if (8 * n8 < c)
#pragma unroll
            for (int h = 0; h < 2; ++h) mean[h] += acc[4 * n8 + 2 * h] + acc[4 * n8 + 2 * h + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mean[h] += __shfl_xor_sync(0xffffffffu, mean[h], 1);
          mean[h] += __shfl_xor_sync(0xffffffffu, mean[h], 2);
          mean[h] /= c;
        }
#pragma unroll
        for (int n8 = 0; n8 < CP / 8; ++n8)
          if (8 * n8 < c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float d = acc[4 * n8 + e] - mean[e / 2];
              var[e / 2] += d * d;
            }
        float rstd[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          var[h] += __shfl_xor_sync(0xffffffffu, var[h], 1);
          var[h] += __shfl_xor_sync(0xffffffffu, var[h], 2);
          rstd[h] = rsqrtf(var[h] / c + kEps);
        }
#pragma unroll
        for (int n8 = 0; n8 < CP / 8; ++n8)
          if (8 * n8 < c) {
            const float2 gg = pair(gam, n8), ee = pair(bet, n8);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[4 * n8 + e] = (acc[4 * n8 + e] - mean[e / 2]) * rstd[e / 2] *
                                    (e % 2 ? gg.y : gg.x) + (e % 2 ? ee.y : ee.x);
          }
      }
      // out = x + bf16(o) in bf16, written over the x tile in place (each
      // thread reads and writes the same elements), then stored by TMA
#pragma unroll
      for (int n8 = 0; n8 < CP / 8; ++n8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (8 * n8 >= c) continue;
          const int r = cw * 64 + warp * 16 + lane / 4 + 8 * h;
          __nv_bfloat162* px =
              reinterpret_cast<__nv_bfloat162*>(xt + tile_offset(r, n8, X_BOX) + 4 * q);
          const float2 xv = __bfloat1622float2(*px);
          const float o0 = __bfloat162float(__float2bfloat16(acc[4 * n8 + 2 * h]));
          const float o1 = __bfloat162float(__float2bfloat16(acc[4 * n8 + 2 * h + 1]));
          *reinterpret_cast<uint32_t*>(px) = pack_bf16(xv.x + o0, xv.y + o1);
        }
      fence_proxy_async();  // the tile's generic writes, before the TMA stores read them
      named_sync(1 + cw, 128);
      if (wt == 0) {
#pragma unroll
        for (int kb = 0; kb < L::KB; ++kb)
          tma_store_2d(&tout, xt + kb * X_BOX + cw * tma::BOX_BYTES, 64 * kb,
                       t * ROWS + cw * 64);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(&xempty[xsl]);  // the slot may be loaded again
      }
    }
    if (wt == 0) bulk_wait_all();  // shared memory outlives the stores
  }
}

template <int CP, bool POST>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tout, const CUtensorMap& tw1,
                   const CUtensorMap& tw2, const void* gam, const void* bet, const void* b1,
                   const void* b2, int m, int c, int hidden, int grid, cudaStream_t s) {
  using L = Layout<CP, POST>;
  using B = __nv_bfloat16;
  cudaFuncSetAttribute(fused_ff_wgmma<CP, POST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L::SMEM);
  fused_ff_wgmma<CP, POST><<<grid, L::THREADS, L::SMEM, s>>>(
      tx, tout, tw1, tw2, static_cast<const B*>(gam), static_cast<const B*>(bet),
      static_cast<const B*>(b1), static_cast<const B*>(b2), m, c, hidden);
  return cudaGetLastError();
}

// CP for a width c (a multiple of 8): 64, 128 or 256; 0 past 256
__host__ inline int padded_width(int c) {
  int cp = 64;
  while (cp < c) cp *= 2;
  return cp <= 256 ? cp : 0;
}

}  // namespace fused

// ---------------------------------------------------------------- f32
constexpr int BM32 = 16;
constexpr int HC32 = 64;
constexpr int COLS32 = MAX_C / THREADS_F32;  // output columns per thread

template <bool POST>
__global__ void __launch_bounds__(THREADS_F32)
fused_ff_f32(const float* __restrict__ x, const float* __restrict__ gam,
             const float* __restrict__ bet, const float* __restrict__ w1,
             const float* __restrict__ b1, const float* __restrict__ w2,
             const float* __restrict__ b2, float* __restrict__ out, int m, int c, int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* y = reinterpret_cast<float*>(smem);  // (BM32, c)
  float* hs = y + BM32 * c;                   // (BM32, HC32)
  const int m0 = blockIdx.x * BM32;

  if constexpr (POST)
    copy_rows(x, y, m0, BM32, m, c);
  else
    layer_norm_rows(x, gam, bet, y, c, m0, BM32, m, c, c);

  float acc[BM32][COLS32];
#pragma unroll
  for (int r = 0; r < BM32; ++r)
#pragma unroll
    for (int j = 0; j < COLS32; ++j) acc[r][j] = 0.f;

  const int j1 = threadIdx.x % HC32, rq = threadIdx.x / HC32;  // 4 row quads
  for (int h0 = 0; h0 < hidden; h0 += HC32) {
    __syncthreads();
    if (h0 + j1 < hidden) {
      float h[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < c; ++k) {
        const float wv = w1[(size_t)k * hidden + h0 + j1];
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = fmaf(y[(rq * 4 + i) * c + k], wv, h[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) hs[(rq * 4 + i) * HC32 + j1] = gelu(h[i] + b1[h0 + j1]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) hs[(rq * 4 + i) * HC32 + j1] = 0.f;
    }
    __syncthreads();
    const int hn = min(HC32, hidden - h0);
    for (int j = 0; j < hn; ++j) {
#pragma unroll
      for (int q = 0; q < COLS32; ++q) {
        const int k = threadIdx.x + q * THREADS_F32;
        if (k < c) {
          const float wv = w2[(size_t)(h0 + j) * c + k];
#pragma unroll
          for (int r = 0; r < BM32; ++r) acc[r][q] = fmaf(hs[r * HC32 + j], wv, acc[r][q]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < COLS32; ++q) {
    const int k = threadIdx.x + q * THREADS_F32;
#pragma unroll
    for (int r = 0; r < BM32; ++r) acc[r][q] = k < c ? acc[r][q] + b2[k] : 0.f;
  }
  if constexpr (POST) {
    // LN of each f32 row: per-warp partial sums in shared memory, summed in
    // a fixed order; two passes (mean, then squared deviations)
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* red = hs;  // [BM32][WARPS_F32]
    float mean[BM32], rstd[BM32];
    auto row_sum = [&](float (&v)[BM32]) {
      __syncthreads();  // the previous readers of hs are done
#pragma unroll
      for (int r = 0; r < BM32; ++r) {
        const float s = warp_sum(v[r]);
        if (lane == 0) red[r * WARPS_F32 + warp] = s;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < BM32; ++r) {
        float s = 0.f;
        for (int w = 0; w < WARPS_F32; ++w) s += red[r * WARPS_F32 + w];
        v[r] = s;
      }
    };
#pragma unroll
    for (int r = 0; r < BM32; ++r) {
      mean[r] = 0.f;
#pragma unroll
      for (int q = 0; q < COLS32; ++q) mean[r] += acc[r][q];  // zero past c
    }
    row_sum(mean);
#pragma unroll
    for (int r = 0; r < BM32; ++r) {
      mean[r] /= c;
      rstd[r] = 0.f;
#pragma unroll
      for (int q = 0; q < COLS32; ++q) {
        const float d = acc[r][q] - mean[r];
        if (threadIdx.x + q * THREADS_F32 < c) rstd[r] += d * d;
      }
    }
    row_sum(rstd);
#pragma unroll
    for (int r = 0; r < BM32; ++r) rstd[r] = rsqrtf(rstd[r] / c + kEps);
#pragma unroll
    for (int q = 0; q < COLS32; ++q) {
      const int k = threadIdx.x + q * THREADS_F32;
      if (k >= c) continue;
#pragma unroll
      for (int r = 0; r < BM32; ++r)
        acc[r][q] = (acc[r][q] - mean[r]) * rstd[r] * gam[k] + bet[k];
    }
  }
#pragma unroll
  for (int q = 0; q < COLS32; ++q) {
    const int k = threadIdx.x + q * THREADS_F32;
    if (k >= c) continue;
#pragma unroll
    for (int r = 0; r < BM32; ++r) {
      if (m0 + r >= m) continue;
      const size_t at = (size_t)(m0 + r) * c + k;
      out[at] = x[at] + acc[r][q];
    }
  }
}

template <bool POST>
void launch_f32(const void* x, const void* gam, const void* bet, const void* w1, const void* b1,
                const void* w2, const void* b2, void* out, int m, int c, int hidden,
                cudaStream_t s) {
  const size_t smem = (size_t)(BM32 * c + BM32 * HC32) * 4;
  cudaFuncSetAttribute(fused_ff_f32<POST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  fused_ff_f32<POST><<<(m + BM32 - 1) / BM32, THREADS_F32, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(gam),
      static_cast<const float*>(bet), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), m, c, hidden);
}

// ---------------------------------------------------------------- bf16, split
// The route for C > 256 and ragged C (cuda_ff.ff_plan): the
// hidden activations leave the SM once, in bf16, and both products run on
// wgmma through tma_gemm.cuh's mainloop:
//   (pre-norm) ln_rows: y = LN(x) in bf16 (ff_rows.cuh);
//   fc1: H = GELU(A . w1 + b1) in bf16, A = y (pre-norm) or x (post-norm);
//   fc2: pre-norm out = x + bf16(H . w2 + b2); post-norm z = H . w2 in f32,
//        then out_rows: x + bf16(LN(z + b2)) (ff_rows.cuh).
// The rounding points are the fused kernel's. Every operand is row-major:
// A (rows x K) lands K-major in 128-row x 64 boxes, B (K x N) MN-major in
// 64 x 64 boxes; TMA zero-fills past M, K and N, so only stores are masked.
enum Epilogue { kEpiGelu = 0, kEpiResidual = 1, kEpiF32 = 2 };

struct GemmArgs {
  int m, n, steps;                 // output rows and columns, K steps of 64
  const __nv_bfloat16* bias;       // (n,): b1 (kEpiGelu) or b2 (kEpiResidual)
  const __nv_bfloat16* x;          // the residual (kEpiResidual), rows of n
  void* out;                       // H (bf16), out (bf16) or z (f32), rows of n
};

template <int BN, int EPI, int CTAS>
__global__ void __launch_bounds__(tma::Ring<BN, CTAS>::THREADS, CTAS)
ff_gemm(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
        const GemmArgs g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 128;
  tma::gemm_tile<BN, CTAS>(
      smem_raw, g.steps,
      [&](int it, unsigned char* st, uint64_t* bar) {
        tma_load_2d(st, &ta, bar, it * tma::KS, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(st + tma::A_BYTES + j * tma::BOX_BYTES, &tb, bar, n0 + 64 * j,
                      it * tma::KS);
      },
      [&](float (&acc)[BN / 2], int cw) {
        const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + cw * 64 + warp * 16 + lane / 4 + 8 * h;
          if (row >= g.m) continue;
          const size_t at = (size_t)row * g.n;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * (lane % 4);  // n % 8 == 0: col + 1 is in range too
            if (col >= g.n) continue;
            const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
            if constexpr (EPI == kEpiF32) {
              *reinterpret_cast<float2*>(static_cast<float*>(g.out) + at + col) = make_float2(a0, a1);
            } else {
              const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(g.bias + col);
              const float v0 = a0 + __low2float(bb), v1 = a1 + __high2float(bb);
              uint32_t packed;
              if constexpr (EPI == kEpiGelu) {
                packed = pack_bf16(gelu(v0), gelu(v1));
              } else {  // bf16(o), then + x in bf16
                const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(g.x + at + col);
                packed = pack_bf16(__low2float(xv) + __bfloat162float(__float2bfloat16(v0)),
                                   __high2float(xv) + __bfloat162float(__float2bfloat16(v1)));
              }
              *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(g.out) + at + col) = packed;
            }
          }
        }
      });
}

// A launch of ff_gemm<BN, EPI, CTAS> over g's output
template <int BN, int EPI, int CTAS>
cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const GemmArgs& g,
                        cudaStream_t s) {
  using R = tma::Ring<BN, CTAS>;
  cudaFuncSetAttribute(ff_gemm<BN, EPI, CTAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)R::SMEM);
  const dim3 grid((g.n + BN - 1) / BN, (g.m + 127) / 128);  // the N tile fastest
  ff_gemm<BN, EPI, CTAS><<<grid, R::THREADS, R::SMEM, s>>>(ta, tb, g);
  return cudaGetLastError();
}

// fc2: bn output columns a block (64, 128, 192 or 256), one block an SM
template <int EPI>
cudaError_t launch_fc2(int bn, const CUtensorMap& ta, const CUtensorMap& tb, const GemmArgs& g,
                       cudaStream_t s) {
  switch (bn) {
    case 64: return launch_gemm<64, EPI, 1>(ta, tb, g, s);
    case 128: return launch_gemm<128, EPI, 1>(ta, tb, g, s);
    case 192: return launch_gemm<192, EPI, 1>(ta, tb, g, s);
    case 256: return launch_gemm<256, EPI, 1>(ta, tb, g, s);
    default: return cudaErrorInvalidValue;
  }
}

using tma::operand_map;

cudaError_t split_fc1(const __nv_bfloat16* in, const __nv_bfloat16* w1, const __nv_bfloat16* b1,
                      __nv_bfloat16* h, int m, int ld, int hidden, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (!operand_map(&ta, in, m, ld, 128) || !operand_map(&tb, w1, ld, hidden, 64))
    return cudaErrorInvalidValue;
  return launch_gemm<128, kEpiGelu, 2>(
      ta, tb, GemmArgs{m, hidden, (ld + tma::KS - 1) / tma::KS, b1, nullptr, h}, s);
}

cudaError_t split_fc2_f32(const __nv_bfloat16* h, const __nv_bfloat16* w2, float* z, int m,
                          int ld, int hidden, int bn2, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (!operand_map(&ta, h, m, hidden, 128) || !operand_map(&tb, w2, hidden, ld, 64))
    return cudaErrorInvalidValue;
  return launch_fc2<kEpiF32>(
      bn2, ta, tb, GemmArgs{m, ld, (hidden + tma::KS - 1) / tma::KS, nullptr, nullptr, z}, s);
}

}  // namespace ff
}  // namespace credit

using namespace credit;

// The fused kernel. x (m, c), out (m, c); gam, bet, b2 (c,), w1 (c,
// hidden), b1 (hidden,), w2 (hidden, c); every pointer 16-byte aligned.
// bf16: c <= 256 and hidden multiples of 8, cpad = c padded to 64, 128 or
// 256 (cuda_ff.ff_plan; TMA zero-fills each tile to it), grid: the
// persistent blocks (at most one an SM). f32: c <= 1024, any hidden, cpad
// == c, grid unused.
// post_norm: 0 for x + fc2(GELU(fc1(LN(x)))), 1 for x + LN(fc2(GELU(fc1(x)))).
extern "C" int credit_fused_ff(const void* x, const void* gam, const void* bet, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* out,
                               int dtype, int m, int c, int cpad, int hidden, int post_norm,
                               int grid, void* stream) {
  using namespace credit::ff;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || c < 1 || c > MAX_C || c % 8) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) {
    if (cpad != fused::padded_width(c) || hidden < 8 || hidden % 8 || grid < 1)
      return (int)cudaErrorInvalidValue;
    CUtensorMap tx, tout, tw1, tw2;
    if (!tma::operand_map(&tx, x, m, c, 64 * fused::warpgroups(cpad)) ||
        !tma::operand_map(&tout, out, m, c, 64) ||
        !tma::operand_map(&tw1, w1, c, hidden, 64) || !tma::operand_map(&tw2, w2, hidden, c, 64))
      return (int)cudaErrorInvalidValue;
    using fused::launch;
    decltype(&launch<64, true>) go;
    if (post_norm)
      go = cpad == 64 ? &launch<64, true> : cpad == 128 ? &launch<128, true> : &launch<256, true>;
    else
      go = cpad == 64    ? &launch<64, false>
           : cpad == 128 ? &launch<128, false>
                         : &launch<256, false>;
    return (int)go(tx, tout, tw1, tw2, gam, bet, b1, b2, m, c, hidden, grid, s);
  } else if (dtype == kF32) {
    if (cpad != c) return (int)cudaErrorInvalidValue;
    if (post_norm)
      launch_f32<true>(x, gam, bet, w1, b1, w2, b2, out, m, c, hidden, s);
    else
      launch_f32<false>(x, gam, bet, w1, b1, w2, b2, out, m, c, hidden, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The split route, bf16 (see above): x, out (m, ld); gam, bet, b2 (ld,), w1
// (ld, hidden), b1 (hidden,), w2 (hidden, ld), zero-padded past the true
// width c; ld and hidden multiples of 8, every pointer 16-byte aligned.
// Workspace from the caller: y (m, ld) bf16 (pre-norm; else unused), h (m,
// hidden) bf16, z (m, ld) f32 (post-norm; else unused). fc1 runs 128 x 128
// tiles, two blocks an SM, so that one block's GELU epilogue runs beside the
// other's products; bn2: fc2's output columns a block (cuda_ff.ff_plan).
extern "C" int credit_fused_ff_split(const void* x, const void* gam, const void* bet,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* out, void* y, void* h, void* z, int m,
                                     int c, int ld, int hidden, int post_norm, int bn2,
                                     void* stream) {
  using namespace credit::ff;
  using B = __nv_bfloat16;
  if (m < 1 || c < 1 || ld < c || ld % 8 || hidden < 8 || hidden % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const B* fc1_in = static_cast<const B*>(x);
  if (!post_norm) {
    (ld > c ? ln_rows<B, true> : ln_rows<B, false>)<<<(m + ROW_WARPS - 1) / ROW_WARPS,
                                                     ROW_THREADS, 0, s>>>(
        static_cast<const B*>(x), static_cast<const B*>(gam), static_cast<const B*>(bet),
        static_cast<B*>(y), m, c, ld);
    fc1_in = static_cast<const B*>(y);
  }
  cudaError_t err = split_fc1(fc1_in, static_cast<const B*>(w1), static_cast<const B*>(b1),
                              static_cast<B*>(h), m, ld, hidden, s);
  if (err != cudaSuccess) return (int)err;
  if (post_norm) {
    err = split_fc2_f32(static_cast<const B*>(h), static_cast<const B*>(w2), static_cast<float*>(z),
                        m, ld, hidden, bn2, s);
    if (err != cudaSuccess) return (int)err;
    out_rows<B, true><<<(m + ROW_WARPS - 1) / ROW_WARPS, ROW_THREADS, 0, s>>>(
        static_cast<const B*>(x), static_cast<const float*>(z), static_cast<const B*>(b2),
        static_cast<const B*>(gam), static_cast<const B*>(bet), static_cast<B*>(out), m, c, ld);
  } else {
    CUtensorMap ta2, tb2;
    if (!operand_map(&ta2, h, m, hidden, 128) || !operand_map(&tb2, w2, hidden, ld, 64))
      return (int)cudaErrorInvalidValue;
    err = launch_fc2<kEpiResidual>(
        bn2, ta2, tb2,
        GemmArgs{m, ld, (hidden + tma::KS - 1) / tma::KS, static_cast<const B*>(b2),
                 static_cast<const B*>(x), out},
        s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
