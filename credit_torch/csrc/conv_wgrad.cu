// Weight gradient of the stride-1 VALID conv, NHWC x, NHWC gy -> f32 HWIO:
//   gk[di, dj, c, o] = sum_{n, y, x} x[n, y + di, x + dj, c] * gy[n, y, x, o].
//
// Replaces credit_tpu/ops/pallas_conv.py conv2d_wgrad (the pallas_call at
// :320). In the port's training step it gives the kernel gradient of every
// conv with kh*kw > 1: the four patch embeds (8x8 after space-to-depth at
// stage 0, 2x2 at stages 1-3), the six 3x3 decoder residual convs and the
// head's 3x3 phase conv; in FuXi's, the DownBlock's 2x2 (its 3x3/s2 after
// space-to-depth) and the four 3x3 residual convs.
//
// Bound on the H100: operations. The stage-0 embed's gradient is an 8x8 x
// 240 x 176 product over 408x728 pixels, 1.61 TFLOP against ~0.25 GB of
// traffic, far above the card's ~295 FLOP/byte ridge. bf16 runs the products
// on wgmma fed by TMA, as kernel 2 does; f32 runs them on the tensor cores
// as 3xTF32 (common.cuh) with mma.sync.
//
// bf16 design: a GEMM per tap, gk[tap] = x_tap^T . gy, with the pixels as
// the contraction. A block owns (tap, a tile of 128 input channels, a tile
// of BN output channels, a split of the pixels); K steps are 64 pixels, SH
// output rows x SW columns (SW 64, 32 or 16, picked by the wrapper to waste
// the fewest pixels at the right edge).
//   A: two TMA boxes {64 channels, SW, SH, 1} of x at {c0, x0 + dj, y + di,
//      b} (one per consumer warpgroup), 64 pixel rows of 128 bytes each:
//      MN-major (channels contiguous), read with wgmma's transpose bit.
//   B: BN / 64 boxes {64 outputs, SW, SH, 1} of gy at {o0, x0, y, b}, MN-major
//      as well. Pixels past Wo and Ho come as zeros from gy's zero fill, so
//      no load is masked (x may read real pixels there: they meet zeros).
//   Pipeline, warp roles and the stage ring as in kernel 2 (conv_valid.cu).
// The tap is the fastest grid index and every block walks its split's
// pixels in the same order, so the kh*kw blocks that read one chunk of x and
// gy run together and find it in L2 (the 8x8 embed's gy is 104 MB and x 146
// MB, both beyond the 50 MB L2).
//
// f32 design: wgmma takes tf32 operands K-major only, and here neither is
// (x and gy keep their channels contiguous, the contraction runs over the
// pixels), so the products run on mma.sync.m16n8k8.tf32, whose fragments
// come from registers loaded in any layout: no transpose pass through shared
// memory, and each value is split hi / lo in the registers it is loaded to.
// Each k8 step's three products go into a fresh accumulator that is added
// to the sum in registers (the tensor cores' f32 accumulation truncates:
// common.cuh).
// A block owns (a row of TC taps (di, dj0 .. dj0 + TC - 1), a tile of 64
// input channels, a tile of BN = 16, 32 or 64 output channels, a split of
// the pixels); a K step is one row segment of 32 output pixels. Its stage
// holds gy's 32 pixels x BN and x's 32 + TC - 1 pixels x 64 channels of row
// y + di, which every tap of the row reads shifted by dj: x is staged once
// for TC taps. 16-byte cp.async with zero fill past the tensors, a ring of
// 4 stages, rows padded by 8 floats so that the fragment loads meet no bank
// conflict. 8 warps: 4 x 16 input channels by 2 x BN / 2 outputs.
//
// The TPU kernel summed its tiles in order into one VMEM block; here blocks
// run in parallel, so each split writes its own partial gk to a scratch
// buffer (the caller's) and a second pass adds the splits in a fixed order:
// the result does not change from run to run. TMA and the 16-byte copies
// need 16-byte strides: the wrapper zero-pads Cin and Cout to multiples of
// 8 (bf16) or 4 (f32). The TPU kernel's lane tricks (the f32 roll, gy padded
// to the lane tile, the Cin sublane pad) have no counterpart.
#include <algorithm>

#include "common.cuh"

namespace credit {
namespace wgrad {

// ---------------------------------------------------------------- bf16
constexpr int TC_THREADS = 384;         // a producer warpgroup and two consumers
constexpr int KP = 64;                  // pixels per K step
constexpr int BOX_BYTES = KP * 64 * 2;  // one box: 64 pixels x 64 channels
constexpr int A_BYTES = 2 * BOX_BYTES;  // 128 input channels

template <int BN>
struct Ring {
  static constexpr int STAGE = A_BYTES + BN / 64 * BOX_BYTES;
  static constexpr int STAGES = (kMaxSmem - 2048) / STAGE < 8 ? (kMaxSmem - 2048) / STAGE : 8;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
};

struct TcGeom {
  int kw, taps, cin, cout;
  int nct;              // input-channel tiles of 128
  int sw_log2;          // SW = 1 << sw_log2, SH = 64 / SW
  int nxs, nys;         // pixel segments per row band, row bands per image
  int nchunks, per;     // K steps in all and per split
};

template <int BN>
__global__ void __launch_bounds__(TC_THREADS, 1)
wgrad_bf16(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tg,
           float* __restrict__ part, TcGeom g) {
  using R = Ring<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  int t = blockIdx.x;
  const int tap = t % g.taps;
  t /= g.taps;
  const int c0 = (t % g.nct) * 128, o0 = (t / g.nct) * BN;
  const int di = tap / g.kw, dj = tap % g.kw;
  const int split = blockIdx.y;
  const int ch0 = split * g.per, nch = max(0, min(g.nchunks, ch0 + g.per) - ch0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      const int sw = 1 << g.sw_log2, sh = KP >> g.sw_log2;
      int xs = ch0 % g.nxs, ys = ch0 / g.nxs % g.nys, b = ch0 / (g.nxs * g.nys), s = 0;
      uint32_t ph = 0;
      for (int it = 0; it < nch; ++it) {
        const int x0 = xs * sw, y0 = ys * sh;
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = smem + s * R::STAGE;
        mbar_expect_tx(&full[s], R::STAGE);
        tma_load_4d(st, &tx, &full[s], c0, x0 + dj, y0 + di, b);
        tma_load_4d(st + BOX_BYTES, &tx, &full[s], c0 + 64, x0 + dj, y0 + di, b);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_4d(st + A_BYTES + j * BOX_BYTES, &tg, &full[s], o0 + 64 * j, x0, y0, b);
        if (++xs == g.nxs) {
          xs = 0;
          if (++ys == g.nys) {
            ys = 0;
            ++b;
          }
        }
        if (++s == R::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {  // consumers: warpgroup cw owns channels [c0 + 64 cw, c0 + 64 cw + 64)
    reg_alloc<232>();
    const int cw = wg - 1, lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int s = 0, prev = -1;
    uint32_t ph = 0;
    for (int it = 0; it < nch; ++it) {
      mbar_wait(&full[s], ph);
      const uint32_t a0 = smem_u32(smem + s * R::STAGE + cw * BOX_BYTES);
      const uint32_t b0 = smem_u32(smem + s * R::STAGE + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)  // both MN-major: a k16 step is 16 rows
        Wgmma<BN>::template run<1, 1>(acc, desc_sw128(a0 + kk * 2048, BOX_BYTES, 1024),
                                      desc_sw128(b0 + kk * 2048, BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == R::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    float* dst = part + (size_t)split * g.taps * g.cin * g.cout + (size_t)tap * g.cin * g.cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + cw * 64 + warp * 16 + lane / 4 + 8 * h;
      if (c >= g.cin) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int o = o0 + 8 * j + 2 * (lane % 4);  // cout % 8 == 0: o + 1 is in range too
        if (o < g.cout)
          *reinterpret_cast<float2*>(dst + (size_t)c * g.cout + o) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int BN>
cudaError_t launch_bf16(const CUtensorMap& tx, const CUtensorMap& tg, float* part,
                        const TcGeom& g, int splits, cudaStream_t s) {
  const dim3 grid(g.taps * g.nct * ((g.cout + BN - 1) / BN), splits);
  cudaFuncSetAttribute(wgrad_bf16<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Ring<BN>::SMEM);
  wgrad_bf16<BN><<<grid, TC_THREADS, Ring<BN>::SMEM, s>>>(tx, tg, part, g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32
constexpr int F_THREADS = 256;  // 8 warps: 4 over the channels, 2 over the outputs
constexpr int F_BM = 64;        // input channels a block
constexpr int F_P = 32;         // output pixels a K step: one row segment
constexpr int F_STAGES = 4;
constexpr int F_LDX = F_BM + 8;  // staged x row: 72 floats, so 8t + g spreads the banks

struct F32Geom {
  int hp, wp, cin, kh, kw, cout, ho, wo;
  int nxc;              // row segments per output row
  int nchunks, per;     // K steps in all and per split
  int n_ct, n_ot, ngc;  // channel tiles, output tiles, tap groups per kernel row
};

template <int BN, int TC>
struct F32Tile {
  static constexpr int XW = F_P + TC - 1;  // x pixels a stage
  static constexpr int LDG = BN + 8;       // staged gy row (24, 40 or 72: conflict-free)
  static constexpr int XS = XW * F_LDX, GS = F_P * LDG;  // floats a stage
  static constexpr int NT = BN / 16;      // n8 tiles a warp
  static constexpr size_t SMEM = (size_t)F_STAGES * (XS + GS) * 4;
};

template <int BN, int TC>
__global__ void __launch_bounds__(F_THREADS, 2)
wgrad_tf32(const float* __restrict__ x, const float* __restrict__ gy, float* __restrict__ part,
           F32Geom g) {
  using T = F32Tile<BN, TC>;
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                     // [F_STAGES][XW][F_LDX]
  float* gs = fsm + F_STAGES * T::XS;  // [F_STAGES][F_P][LDG]
  int t = blockIdx.x;
  const int o0 = (t % g.n_ot) * BN;
  t /= g.n_ot;
  const int c0 = (t % g.n_ct) * F_BM;
  t /= g.n_ct;
  const int dj0 = (t % g.ngc) * TC, di = t / g.ngc;
  const int ch0 = blockIdx.y * g.per, nch = max(0, min(g.nchunks, ch0 + g.per) - ch0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int m0 = 16 * (warp % 4), nw = (BN / 2) * (warp / 4);

  // K step ci (image, output row y, columns x0..) into stage st
  auto load = [&](int ci, int st) {
    const int x0 = (ci % g.nxc) * F_P, y = (ci / g.nxc) % g.ho, b = ci / (g.nxc * g.ho);
    float* xd = xs + st * T::XS;
    float* gd = gs + st * T::GS;
    const float* xrow = x + (size_t)(b * g.hp + y + di) * g.wp * g.cin;
    for (int e = threadIdx.x; e < T::XW * (F_BM / 4); e += F_THREADS) {
      const int p = e / (F_BM / 4), q = 4 * (e % (F_BM / 4));
      const int xx = x0 + dj0 + p, c = c0 + q;
      const bool in = xx < g.wp && c < g.cin;
      cp_async16_zfill(xd + p * F_LDX + q, in ? xrow + (size_t)xx * g.cin + c : x, in);
    }
    const float* grow = gy + (size_t)(b * g.ho + y) * g.wo * g.cout;
    for (int e = threadIdx.x; e < F_P * (BN / 4); e += F_THREADS) {
      const int p = e / (BN / 4), q = 4 * (e % (BN / 4));
      const int xx = x0 + p, o = o0 + q;
      const bool in = xx < g.wo && o < g.cout;
      cp_async16_zfill(gd + p * T::LDG + q, in ? grow + (size_t)xx * g.cout + o : gy, in);
    }
  };

  float acc[TC][T::NT][4];
#pragma unroll
  for (int tc = 0; tc < TC; ++tc)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tc][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < F_STAGES - 1; ++st) {
    if (st < nch) load(ch0 + st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nch; ++it) {
    cp_async_wait<F_STAGES - 2>();  // step it has landed
    __syncthreads();                // ... for every thread, and step it - 1 is read
    if (it + F_STAGES - 1 < nch) load(ch0 + it + F_STAGES - 1, (it + F_STAGES - 1) % F_STAGES);
    cp_async_commit();
    const float* xd = xs + (it % F_STAGES) * T::XS;
    const float* gd = gs + (it % F_STAGES) * T::GS;
#pragma unroll
    for (int k0 = 0; k0 < F_P; k0 += 8) {
      // B = gy (k = pixel, n = output): b0 = B[tq][gq], b1 = B[tq + 4][gq]
      uint32_t bh[T::NT][2], bl[T::NT][2];
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          split_tf32(gd[(k0 + tq + 4 * r) * T::LDG + nw + 8 * j + gq], bh[j][r], bl[j][r]);
#pragma unroll
      for (int tc = 0; tc < TC; ++tc) {
        // A = x^T (m = channel, k = pixel), the tap's pixels shifted by tc
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(xd[(k0 + tq + 4 * (i >> 1) + tc) * F_LDX + m0 + gq + 8 * (i & 1)], ah[i],
                     al[i]);
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {  // the k8 step's products, then into the sum
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(part, al, bh[j]);
          mma_tf32(part, ah, bl[j]);
          mma_tf32(part, ah, bh[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[tc][j][e] += part[e];
        }
      }
    }
  }
  cp_async_wait<0>();
  float* dst = part + (size_t)blockIdx.y * g.kh * g.kw * g.cin * g.cout;
#pragma unroll
  for (int tc = 0; tc < TC; ++tc) {
    const int dj = dj0 + tc;
    if (dj >= g.kw) continue;
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + m0 + gq + 8 * h, o = o0 + nw + 8 * j + 2 * tq;
        if (c < g.cin && o < g.cout)  // cout % 4 == 0: o + 1 is in range too
          *reinterpret_cast<float2*>(dst + ((size_t)(di * g.kw + dj) * g.cin + c) * g.cout + o) =
              make_float2(acc[tc][j][2 * h], acc[tc][j][2 * h + 1]);
      }
  }
}

template <int BN, int TC>
cudaError_t launch_f32(const float* x, const float* gy, float* part, const F32Geom& g, int splits,
                       cudaStream_t s) {
  using T = F32Tile<BN, TC>;
  const dim3 grid(g.n_ot * g.n_ct * g.ngc * g.kh, splits);
  cudaFuncSetAttribute(wgrad_tf32<BN, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)T::SMEM);
  wgrad_tf32<BN, TC><<<grid, F_THREADS, T::SMEM, s>>>(x, gy, part, g);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_f32_tc(int tc, const float* x, const float* gy, float* part, const F32Geom& g,
                          int splits, cudaStream_t s) {
  switch (tc) {
    case 1: return launch_f32<BN, 1>(x, gy, part, g, splits, s);
    case 2: return launch_f32<BN, 2>(x, gy, part, g, splits, s);
    case 3: return launch_f32<BN, 3>(x, gy, part, g, splits, s);
    case 4: return launch_f32<BN, 4>(x, gy, part, g, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// out[i] = sum over s < splits of part[s * n + i], in that order
__global__ void sum_splits(const float* __restrict__ part, float* __restrict__ out, size_t n,
                           int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
    out[i] = s;
  }
}

}  // namespace wgrad
}  // namespace credit

using namespace credit;

// x (n, hp, wp, cin), gy (n, hp-kh+1, wp-kw+1, cout), one dtype (kF32 or
// kBF16), contiguous and 16-byte aligned; gk (kh, kw, cin, cout) f32. The
// wrapper's plan: bf16 takes cin and cout multiples of 8, bn (64, 128, 192
// or 256) output channels a block and K steps of 64 pixels sw (16, 32 or
// 64) wide, one tap a block (tr = tc = 1); f32 cin and cout multiples of 4,
// bn 16, 32 or 64, sw 32 (one row segment) and a row of tc (1 to 4) taps a
// block (tr = 1). `splits` blocks share each tile's pixels; with more than
// one, `work` holds splits x kh x kw x cin x cout f32 partials, added in
// order into gk.
extern "C" int credit_conv_wgrad(const void* x, const void* gy, void* gk, void* work, int dtype,
                                 int n, int hp, int wp, int cin, int kh, int kw, int cout, int bn,
                                 int sw, int tr, int tc, int splits, void* stream) {
  using namespace credit::wgrad;
  if (n < 1 || kh < 1 || kw < 1 || hp < kh || wp < kw || cin < 1 || cout < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ho = hp - kh + 1, wo = wp - kw + 1;
  float* part = splits > 1 ? static_cast<float*>(work) : static_cast<float*>(gk);
  if (dtype == kBF16) {
    if (cin % 8 || cout % 8 || (sw != 16 && sw != 32 && sw != 64) || tr != 1 || tc != 1)
      return (int)cudaErrorInvalidValue;
    const int sh = KP / sw;
    TcGeom g{kw, kh * kw, cin, cout, (cin + 127) / 128, sw == 16 ? 4 : (sw == 32 ? 5 : 6),
             (wo + sw - 1) / sw, (ho + sh - 1) / sh, 0, 0};
    g.nchunks = n * g.nxs * g.nys;
    g.per = (g.nchunks + splits - 1) / splits;
    CUtensorMap tx, tg;
    const cuuint64_t xd[4] = {(cuuint64_t)cin, (cuuint64_t)wp, (cuuint64_t)hp, (cuuint64_t)n};
    const cuuint64_t xs[3] = {(cuuint64_t)cin * 2, (cuuint64_t)wp * cin * 2,
                              (cuuint64_t)hp * wp * cin * 2};
    const cuuint64_t gd[4] = {(cuuint64_t)cout, (cuuint64_t)wo, (cuuint64_t)ho, (cuuint64_t)n};
    const cuuint64_t gs[3] = {(cuuint64_t)cout * 2, (cuuint64_t)wo * cout * 2,
                              (cuuint64_t)ho * wo * cout * 2};
    const cuuint32_t box[4] = {64, (cuuint32_t)sw, (cuuint32_t)sh, 1};
    if (!bf16_map(&tx, x, 4, xd, xs, box) || !bf16_map(&tg, gy, 4, gd, gs, box))
      return (int)cudaErrorInvalidValue;
    cudaError_t err;
    switch (bn) {
      case 64: err = launch_bf16<64>(tx, tg, part, g, splits, s); break;
      case 128: err = launch_bf16<128>(tx, tg, part, g, splits, s); break;
      case 192: err = launch_bf16<192>(tx, tg, part, g, splits, s); break;
      case 256: err = launch_bf16<256>(tx, tg, part, g, splits, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  } else if (dtype == kF32) {
    if (cin % 4 || cout % 4 || sw != F_P || tr != 1 || tc < 1 || tc > 4)
      return (int)cudaErrorInvalidValue;
    F32Geom g{};
    g.hp = hp, g.wp = wp, g.cin = cin, g.kh = kh, g.kw = kw, g.cout = cout;
    g.ho = ho, g.wo = wo;
    g.nxc = (wo + F_P - 1) / F_P;
    g.nchunks = n * ho * g.nxc;
    g.per = (g.nchunks + splits - 1) / splits;
    g.ngc = (kw + tc - 1) / tc;
    g.n_ct = (cin + F_BM - 1) / F_BM, g.n_ot = (cout + bn - 1) / bn;
    const float* xf = static_cast<const float*>(x);
    const float* gf = static_cast<const float*>(gy);
    cudaError_t err;
    switch (bn) {
      case 16: err = launch_f32_tc<16>(tc, xf, gf, part, g, splits, s); break;
      case 32: err = launch_f32_tc<32>(tc, xf, gf, part, g, splits, s); break;
      case 64: err = launch_f32_tc<64>(tc, xf, gf, part, g, splits, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (splits > 1) {
    const size_t total = (size_t)kh * kw * cin * cout;
    const int blocks = (int)std::min<size_t>((total + 255) / 256, 4096);
    sum_splits<<<blocks, 256, 0, s>>>(part, static_cast<float*>(gk), total, splits);
  }
  return (int)cudaGetLastError();
}
