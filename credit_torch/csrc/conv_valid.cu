// Stride-1 VALID 2-D convolution, NHWC input x HWIO kernel -> NHWC output,
// f32 accumulation, output in the input dtype.
//
// Replaces credit_tpu/ops/pallas_conv.py conv2d_valid (_forward, the
// pallas_call at :174). In the port it carries every patch embed (after the
// space-to-depth rewrite), every 3x3 decoder residual conv, the final 3x3
// depth-to-space phase conv, and (on the padded cotangent, kernel flipped)
// every conv's input gradient; in f32, every 3x3 conv of the U-Net family
// and SKEBS's backscatter net.
//
// Bound on the H100: operations. The flagship's stage-0 embed is an 8x8
// conv over 240 channels to 176 at 408x728 outputs, ~1.6 TFLOP against
// ~0.25 GB of traffic, far above the card's ~295 FLOP/byte ridge; FuXi's
// 3x3 1024 -> 1024 convs likewise. So both dtypes run on the tensor cores
// at the only rate Hopper's reach: wgmma, fed by TMA. f32 runs as 3xTF32
// (common.cuh): three tf32 products a K step, f32 accuracy. With Cout as
// small as SKEBS's 13 the f32 form moves towards bytes: its 723x1442x60 x
// (500 MB) is read once from device memory and once a tap from L2.
//
// Design: an implicit GEMM, M = 128 output pixels (TH x TW rows of the
// output, TW 16, 32 or 64), N = BN output channels (picked by the wrapper),
// K = 128 bytes of input channels of one tap per step (64 bf16 or 32 f32),
// the chunk outer and the kh x kw taps inner, so any kernel size is one loop.
//   A: one TMA load of the 4-D box {channels, TW, TH, 1} of the NHWC input
//      at {c0, x0 + dj, y0 + di, b}: a tap is a shift of the box. It lands
//      as 128 rows of 128 bytes with 128-byte swizzle, the K-major tile that
//      wgmma reads by descriptor. The halo is re-read from L2 (the taps of a
//      chunk follow each other), not staged.
//   B, bf16: BN / 64 TMA boxes {64 outputs, 64 channels, 1} of the HWIO
//      kernel seen as (taps, Cin, Cout): MN-major (Cout contiguous), read
//      with wgmma's transpose bit; no copy of the weights.
//   B, f32: wgmma takes tf32 K-major only. The wrapper splits the kernel
//      once a call into tf32 hi and lo parts, each laid out K-major as
//      (taps, Cout, Cin); a step loads a box {32 channels, BN outputs, 1}
//      of each. A (the large operand) is split on chip: the consumers read
//      their rows of the swizzled A tile into registers as wgmma's A
//      fragments, round hi = rna(a), lo = rna(a - hi), and issue lo . B_hi,
//      hi . B_lo and hi . B_hi from registers, a k8 step at a time into a
//      fresh accumulator that is then added to the sum in registers (the
//      tensor cores' f32 accumulation truncates: common.cuh). BN is at most
//      128, so that the sum, the step's accumulator and the A fragments fit
//      a consumer's 232 registers.
//   Ragged edges: TMA zero-fills what lies outside the tensors (channels
//      past Cin in the last chunk, rows and columns past the input, outputs
//      past Cout in B), so no load is masked; stores past Ho, Wo or Cout are
//      skipped.
//   Pipeline: tma_gemm.cuh's ring of stages, one producer thread, two
//      consumer warpgroups of 64 pixels x BN (bf16: its mainloop as the
//      feed-forward's products use it). f32 accumulators are rounded to the
//      output dtype once, in the epilogue.
// The N tile is the fastest grid index, so the blocks that read one A tile
// run together. TMA needs 16-byte strides: the wrapper zero-pads Cin (bf16
// and f32) and Cout (bf16) to multiples of 8 (bf16) or 4 (f32). Kernels of
// any size run as one K loop (the TPU kernel's sublane padding, f32 column
// rolls and two-ref halo trick have no counterpart).
#include "tma_gemm.cuh"

namespace credit {
namespace conv {

// ---------------------------------------------------------------- bf16
using tma::A_BYTES;
using tma::BOX_BYTES;
using tma::KS;
using tma::Ring;

struct TcGeom {
  int kh, kw, nchunks;  // K steps: nchunks x kh x kw
  int ho, wo, cout;
  int tw_log2;          // TW = 1 << tw_log2, TH = 128 / TW
  int nxt;              // pixel tiles per output row band
};

template <int BN>
__global__ void __launch_bounds__(Ring<BN>::THREADS, 1)
conv_valid_bf16(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tk,
                __nv_bfloat16* __restrict__ out, TcGeom g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int tw = 1 << g.tw_log2, th = 128 >> g.tw_log2;
  const int n0 = blockIdx.x * BN;
  const int x0 = (blockIdx.y % g.nxt) * tw, y0 = (blockIdx.y / g.nxt) * th;
  const int b = blockIdx.z;
  // the producer's step, advanced in order: the chunk outer, the taps inner
  // (dividing the step index on each step slowed the 18-step 3x3 convs 14%)
  int c = 0, di = 0, dj = 0;
  tma::gemm_tile<BN>(
      smem_raw, g.nchunks * g.kh * g.kw,
      [&](int, unsigned char* st, uint64_t* bar) {
        tma_load_4d(st, &tx, bar, c * KS, x0 + dj, y0 + di, b);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(st + A_BYTES + j * BOX_BYTES, &tk, bar, n0 + 64 * j, c * KS,
                      di * g.kw + dj);
        if (++dj == g.kw) {
          dj = 0;
          if (++di == g.kh) {
            di = 0;
            ++c;
          }
        }
      },
      [&](float (&acc)[BN / 2], int cw) {
        const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = cw * 64 + warp * 16 + lane / 4 + 8 * h;
          const int oy = y0 + (p >> g.tw_log2), ox = x0 + (p & (tw - 1));
          if (oy >= g.ho || ox >= g.wo) continue;
          __nv_bfloat16* o = out + ((size_t)(b * g.ho + oy) * g.wo + ox) * g.cout;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int on = n0 + 8 * j + 2 * (lane % 4);  // cout % 8 == 0: on + 1 is in range too
            if (on < g.cout)
              *reinterpret_cast<uint32_t*>(o + on) =
                  pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      });
}

template <int BN>
cudaError_t launch_bf16(const CUtensorMap& tx, const CUtensorMap& tk, void* out, const TcGeom& g,
                        int n, int nyt, cudaStream_t s) {
  const dim3 grid((g.cout + BN - 1) / BN, g.nxt * nyt, n);
  cudaFuncSetAttribute(conv_valid_bf16<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Ring<BN>::SMEM);
  conv_valid_bf16<BN><<<grid, Ring<BN>::THREADS, Ring<BN>::SMEM, s>>>(
      tx, tk, static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32
constexpr int KF = 32;  // f32 K values a step (one 128-byte row)

template <int BN>
struct RingF32 {
  static constexpr int THREADS = 384;
  static constexpr int B_BYTES = BN * KF * 4;  // one of B's two parts
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES = (kMaxSmem - 2048) / STAGE < 8 ? (kMaxSmem - 2048) / STAGE : 8;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
  static_assert(A_BYTES == 128 * KF * 4 && B_BYTES % 1024 == 0, "1024-byte aligned tiles");
  static_assert(BN <= 128, "the sum and a step's accumulator in 232 registers");
};

template <int BN>
__global__ void __launch_bounds__(RingF32<BN>::THREADS, 1)
conv_valid_tf32(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap thi,
                const __grid_constant__ CUtensorMap tlo, float* __restrict__ out, TcGeom g) {
  using R = RingF32<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  tma::ring_init<R>(full, empty);
  const int tw = 1 << g.tw_log2, th = 128 >> g.tw_log2;
  const int n0 = blockIdx.x * BN;
  const int x0 = (blockIdx.y % g.nxt) * tw, y0 = (blockIdx.y / g.nxt) * th;
  const int b = blockIdx.z;
  const int steps = g.nchunks * g.kh * g.kw;
  if (threadIdx.x < 128) {  // producer
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int c = 0, di = 0, dj = 0;  // the chunk outer, the taps inner
      auto load = [&](int, unsigned char* st, uint64_t* bar) {
        const int tap = di * g.kw + dj;
        tma_load_4d(st, &tx, bar, c * KF, x0 + dj, y0 + di, b);
        tma_load_3d(st + A_BYTES, &thi, bar, c * KF, n0, tap);
        tma_load_3d(st + A_BYTES + R::B_BYTES, &tlo, bar, c * KF, n0, tap);
        if (++dj == g.kw) {
          dj = 0;
          if (++di == g.kh) {
            di = 0;
            ++c;
          }
        }
      };
      tma::RingPos pos;
      tma::produce<R>(smem, full, empty, steps, load, pos);
    }
    return;
  }
  reg_alloc<232>();
  const int cw = threadIdx.x / 128 - 1, lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int gq = lane / 4, tq = lane % 4;
  // this thread's A rows, 64 cw + 16 warp + gq and 8 rows down; in the
  // 128-byte swizzle a row's 16-byte chunk q lies at q ^ (row % 8) = q ^ gq
  const int row0 = (64 * cw + 16 * warp + gq) * 128 + tq * 4;
  // the sum, and a k8 step's three products: up to BN = 64 two of those,
  // so that one step's products run while the step before is added
  constexpr int NP = BN <= 64 ? 2 : 1;
  float acc[BN / 2], part[NP][BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = 0.f;
#pragma unroll
    for (int q = 0; q < NP; ++q) part[q][i] = 0.f;
  }
  int s = 0;
  uint32_t ph = 0;
  for (int it = 0; it < steps; ++it) {
    mbar_wait(&full[s], ph);
    const unsigned char* st = smem + s * R::STAGE;
    uint32_t hi[KF / 8][4], lo[KF / 8][4];
#pragma unroll
    for (int kk = 0; kk < KF / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a0..a3: (row, k) = (gq, tq), (gq + 8, tq), (gq, tq + 4), ...
        const int chunk = (2 * kk + (i >> 1)) ^ gq;
        const float v = *reinterpret_cast<const float*>(st + row0 + (i & 1) * 1024 + chunk * 16);
        split_tf32(v, hi[kk][i], lo[kk][i]);
      }
    const uint32_t bh = smem_u32(st + A_BYTES), bl = bh + R::B_BYTES;
#pragma unroll
    for (int kk = 0; kk < KF / 8; ++kk) {  // a k8 step is 32 bytes along the K-major rows
      float(&pk)[BN / 2] = part[kk % NP];
      wgmma_fence();
      WgmmaTF32<BN>::run(pk, lo[kk], desc_sw128(bh + kk * 32, 16, 1024), 0);
      WgmmaTF32<BN>::run(pk, hi[kk], desc_sw128(bl + kk * 32, 16, 1024), 1);
      WgmmaTF32<BN>::run(pk, hi[kk], desc_sw128(bh + kk * 32, 16, 1024), 1);
      wgmma_commit();
      if constexpr (NP == 1) {
        wgmma_wait<0>();
        fence_regs(pk);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += pk[i];
      } else if (kk > 0) {  // the step before is done: add it
        wgmma_wait<1>();
        fence_regs(part[(kk + 1) % NP]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[(kk + 1) % NP][i];
      }
    }
    if constexpr (NP == 2) {
      wgmma_wait<0>();
      fence_regs(part[(KF / 8 - 1) % NP]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[(KF / 8 - 1) % NP][i];
    }
    // the stage and its A registers are free again
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == R::STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = cw * 64 + warp * 16 + gq + 8 * h;
    const int oy = y0 + (p >> g.tw_log2), ox = x0 + (p & (tw - 1));
    if (oy >= g.ho || ox >= g.wo) continue;
    float* o = out + ((size_t)(b * g.ho + oy) * g.wo + ox) * g.cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int on = n0 + 8 * j + 2 * tq;  // any cout: each of the pair masked
      if (on < g.cout) o[on] = acc[4 * j + 2 * h];
      if (on + 1 < g.cout) o[on + 1] = acc[4 * j + 2 * h + 1];
    }
  }
}

template <int BN>
cudaError_t launch_f32(const CUtensorMap& tx, const CUtensorMap& thi, const CUtensorMap& tlo,
                       void* out, const TcGeom& g, int n, int nyt, cudaStream_t s) {
  using R = RingF32<BN>;
  const dim3 grid((g.cout + BN - 1) / BN, g.nxt * nyt, n);
  cudaFuncSetAttribute(conv_valid_tf32<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)R::SMEM);
  conv_valid_tf32<BN><<<grid, R::THREADS, R::SMEM, s>>>(tx, thi, tlo, static_cast<float*>(out), g);
  return cudaGetLastError();
}

}  // namespace conv
}  // namespace credit

using namespace credit;

// x (n, hp, wp, cin), out (n, hp-kh+1, wp-kw+1, cout), contiguous, 16-byte
// aligned and of one dtype (kF32 or kBF16); kh * kw >= 2 (a 1x1 conv is a
// plain GEMM), any kh and kw; the wrapper's plan of bn output channels and
// tw (16, 32 or 64) output columns a block. bf16: w the HWIO kernel (kh,
// kw, cin, cout), cin and cout multiples of 8, bn 64, 128, 192 or 256,
// w_lo unused. f32: w and w_lo the kernel's tf32 hi and lo parts laid out
// (kh * kw, cout, cin), cin a multiple of 4, bn 16, 32, 64 or 128.
extern "C" int credit_conv_valid(const void* x, const void* w, const void* w_lo, void* out,
                                 int dtype, int n, int hp, int wp, int cin, int kh, int kw,
                                 int cout, int bn, int tw, void* stream) {
  using namespace credit::conv;
  if (kh < 1 || kw < 1 || kh * kw < 2 || hp < kh || wp < kw || n < 1 || cin < 1 || cout < 1 ||
      (tw != 16 && tw != 32 && tw != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ho = hp - kh + 1, wo = wp - kw + 1, th = 128 / tw;
  const int nyt = (ho + th - 1) / th;
  const int tw_log2 = tw == 16 ? 4 : (tw == 32 ? 5 : 6);
  const cuuint64_t xd[4] = {(cuuint64_t)cin, (cuuint64_t)wp, (cuuint64_t)hp, (cuuint64_t)n};
  CUtensorMap tx, tk, tlo;
  cudaError_t err;
  if (dtype == kBF16) {
    if (cin % 8 || cout % 8) return (int)cudaErrorInvalidValue;
    TcGeom g{kh, kw, (cin + KS - 1) / KS, ho, wo, cout, tw_log2, (wo + tw - 1) / tw};
    const cuuint64_t xs[3] = {(cuuint64_t)cin * 2, (cuuint64_t)wp * cin * 2,
                              (cuuint64_t)hp * wp * cin * 2};
    const cuuint32_t xb[4] = {KS, (cuuint32_t)tw, (cuuint32_t)th, 1};
    const cuuint64_t kd[3] = {(cuuint64_t)cout, (cuuint64_t)cin, (cuuint64_t)kh * kw};
    const cuuint64_t ks[2] = {(cuuint64_t)cout * 2, (cuuint64_t)cin * cout * 2};
    const cuuint32_t kb[3] = {64, KS, 1};
    if (!bf16_map(&tx, x, 4, xd, xs, xb) || !bf16_map(&tk, w, 3, kd, ks, kb))
      return (int)cudaErrorInvalidValue;
    switch (bn) {
      case 64: err = launch_bf16<64>(tx, tk, out, g, n, nyt, s); break;
      case 128: err = launch_bf16<128>(tx, tk, out, g, n, nyt, s); break;
      case 192: err = launch_bf16<192>(tx, tk, out, g, n, nyt, s); break;
      case 256: err = launch_bf16<256>(tx, tk, out, g, n, nyt, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)err;
  }
  if (dtype != kF32 || cin % 4) return (int)cudaErrorInvalidValue;
  TcGeom g{kh, kw, (cin + KF - 1) / KF, ho, wo, cout, tw_log2, (wo + tw - 1) / tw};
  const cuuint64_t xs[3] = {(cuuint64_t)cin * 4, (cuuint64_t)wp * cin * 4,
                            (cuuint64_t)hp * wp * cin * 4};
  const cuuint32_t xb[4] = {KF, (cuuint32_t)tw, (cuuint32_t)th, 1};
  const cuuint64_t kd[3] = {(cuuint64_t)cin, (cuuint64_t)cout, (cuuint64_t)kh * kw};
  const cuuint64_t ks[2] = {(cuuint64_t)cin * 4, (cuuint64_t)cout * cin * 4};
  const cuuint32_t kb[3] = {KF, (cuuint32_t)bn, 1};
  if (!f32_map(&tx, x, 4, xd, xs, xb) || !f32_map(&tk, w, 3, kd, ks, kb) ||
      !f32_map(&tlo, w_lo, 3, kd, ks, kb))
    return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 16: err = launch_f32<16>(tx, tk, tlo, out, g, n, nyt, s); break;
    case 32: err = launch_f32<32>(tx, tk, tlo, out, g, n, nyt, s); break;
    case 64: err = launch_f32<64>(tx, tk, tlo, out, g, n, nyt, s); break;
    case 128: err = launch_f32<128>(tx, tk, tlo, out, g, n, nyt, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
