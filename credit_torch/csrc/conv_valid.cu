// Stride-1 VALID 2-D convolution, NHWC input x HWIO kernel -> NHWC output,
// f32 accumulation, output in the input dtype.
//
// Replaces credit_tpu/ops/pallas_conv.py conv2d_valid (_forward, the
// pallas_call at :174). In the port it carries every patch embed (after the
// space-to-depth rewrite), every 3x3 decoder residual conv, the final 3x3
// depth-to-space phase conv, and (on the padded cotangent, kernel flipped)
// every conv's input gradient.
//
// Bound on the H100: operations. The flagship's stage-0 embed is an 8x8
// conv over 240 channels to 176 at 408x728 outputs, ~1.6 TFLOP against
// ~0.25 GB of traffic, far above the card's ~295 FLOP/byte ridge; FuXi's
// 3x3 1024 -> 1024 convs likewise. So bf16 runs on the tensor cores at the
// only rate Hopper's reach: wgmma, fed by TMA. The f32 path is plain FMA.
//
// bf16 design: an implicit GEMM, M = 128 output pixels (TH x TW rows of the
// output, TW 16, 32 or 64), N = BN output channels (64, 128, 192 or 256,
// picked by the wrapper), K = 64 input channels of one tap per step, the
// chunk outer and the kh x kw taps inner, so any kernel size is one loop.
//   A: one TMA load of the 4-D box {64 channels, TW, TH, 1} of the NHWC
//      input at {c0, x0 + dj, y0 + di, b}: a tap is a shift of the box. It
//      lands as 128 rows of 128 bytes with 128-byte swizzle, the K-major
//      tile that wgmma reads by descriptor. The halo is re-read from L2
//      (the taps of a chunk follow each other), not staged.
//   B: BN / 64 TMA boxes {64 outputs, 64 channels, 1} of the HWIO kernel
//      seen as (taps, Cin, Cout): MN-major (Cout contiguous), read with
//      wgmma's transpose bit; no copy of the weights.
//   Ragged edges: TMA zero-fills what lies outside the tensors (channels
//      past Cin in the last chunk, rows and columns past the input), so no
//      load is masked; stores past Ho, Wo or Cout are skipped.
//   Pipeline: a ring of stages (A 16 KB + B BN x 128 bytes each) with full
//      and empty mbarriers. One producer thread issues the loads (its
//      warpgroup gives registers away with setmaxnreg); two consumer
//      warpgroups, 64 pixels x BN each, run wgmma.mma_async with one group
//      in flight and free a stage once its products are done. f32
//      accumulators are rounded to bf16 once, in the epilogue.
// The N tile is the fastest grid index, so the blocks that read one A tile
// run together. TMA needs 16-byte strides: the wrapper zero-pads Cin and
// Cout to multiples of 8. Kernels of any size run as one K loop (the TPU
// kernel's sublane padding, f32 column rolls and two-ref halo trick have no
// counterpart).
#include "common.cuh"

namespace credit {
namespace conv {

constexpr int TH = 8;         // f32: output rows per block
constexpr int TW = 16;        // f32: output columns per block
constexpr int BK = 32;        // f32: input channels per staged chunk
constexpr int THREADS = 256;  // f32: 8 warps
constexpr int MAX_K = 8;      // f32: largest kh / kw of one tap group

struct Geom {
  int hp, wp, cin, kh, kw, cout, ho, wo, n_ntiles;
};

__host__ __device__ inline int patch_h(const Geom& g) { return TH + g.kh - 1; }
__host__ __device__ inline int patch_w(const Geom& g) { return TW + g.kw - 1; }

// ---------------------------------------------------------------- bf16
constexpr int TC_THREADS = 384;    // a producer warpgroup and two consumers
constexpr int KS = 64;             // input channels per K step (one 128-byte row)
constexpr int A_BYTES = 128 * KS * 2;
constexpr int BOX_BYTES = 64 * KS * 2;  // one 64-output column block of B

template <int BN>
struct Ring {
  static constexpr int STAGE = A_BYTES + BN * KS * 2;
  static constexpr int STAGES = (kMaxSmem - 2048) / STAGE < 8 ? (kMaxSmem - 2048) / STAGE : 8;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
};

struct TcGeom {
  int kh, kw, nchunks;  // K steps: nchunks x kh x kw
  int ho, wo, cout;
  int tw_log2;          // TW = 1 << tw_log2, TH = 128 / TW
  int nxt;              // pixel tiles per output row band
};

template <int BN>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_valid_bf16(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tk,
                __nv_bfloat16* __restrict__ out, TcGeom g) {
  using R = Ring<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  const int tw = 1 << g.tw_log2, th = 128 >> g.tw_log2;
  const int n0 = blockIdx.x * BN;
  const int x0 = (blockIdx.y % g.nxt) * tw, y0 = (blockIdx.y / g.nxt) * th;
  const int b = blockIdx.z;
  const int total = g.nchunks * g.kh * g.kw;
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
      int c = 0, di = 0, dj = 0, s = 0;
      uint32_t ph = 0;
      for (int it = 0; it < total; ++it) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = smem + s * R::STAGE;
        mbar_expect_tx(&full[s], R::STAGE);
        tma_load_4d(st, &tx, &full[s], c * KS, x0 + dj, y0 + di, b);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(st + A_BYTES + j * BOX_BYTES, &tk, &full[s], n0 + 64 * j, c * KS,
                      di * g.kw + dj);
        if (++dj == g.kw) {
          dj = 0;
          if (++di == g.kh) {
            di = 0;
            ++c;
          }
        }
        if (++s == R::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {  // consumers: warpgroup cw owns pixels [64 cw, 64 cw + 64) of the tile
    reg_alloc<232>();
    const int cw = wg - 1, lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int s = 0, prev = -1;
    uint32_t ph = 0;
    for (int it = 0; it < total; ++it) {
      mbar_wait(&full[s], ph);
      const uint32_t a0 = smem_u32(smem + s * R::STAGE + cw * 64 * 128);
      const uint32_t b0 = smem_u32(smem + s * R::STAGE + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)  // A: K-major, 32 bytes a k16 step; B: 16 rows
        Wgmma<BN>::template run<0, 1>(acc, desc_sw128(a0 + kk * 32, 16, 1024),
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
          *reinterpret_cast<uint32_t*>(o + on) = pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int BN>
cudaError_t launch_bf16(const CUtensorMap& tx, const CUtensorMap& tk, void* out, const TcGeom& g,
                        int n, int nyt, cudaStream_t s) {
  const dim3 grid((g.cout + BN - 1) / BN, g.nxt * nyt, n);
  cudaFuncSetAttribute(conv_valid_bf16<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Ring<BN>::SMEM);
  conv_valid_bf16<BN><<<grid, TC_THREADS, Ring<BN>::SMEM, s>>>(
      tx, tk, static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- groups
// The f32 kernel's tap groups: ngh x ngw groups of gh x gw (a single group
// up to MAX_K a side).
struct Groups {
  int gh, gw, ngh, ngw;
};

// The staged patch covers one group's halo.
__host__ __device__ inline Geom group_patch(Geom g, const Groups& G) {
  g.kh = G.gh, g.kw = G.gw;
  return g;
}

// ---------------------------------------------------------------- f32
constexpr int BN32 = 64;
constexpr int LDA32 = BK + 1;  // f32 patch rows, bank spread
constexpr int LDB32 = BN32 + 4;

// the f32 weight tile starts 16-byte aligned for its float4 accesses
__host__ __device__ inline int patch_f32_floats(const Geom& g) {
  return (int)align_up((size_t)patch_h(g) * patch_w(g) * LDA32, 4);
}

__host__ inline size_t smem_f32(const Geom& g) {
  return (size_t)patch_f32_floats(g) * 4 + (size_t)g.kw * BK * LDB32 * 4;
}

// Stage the gw weight slices w[di, dj0..dj0+gw-1, c0:c0+BK, n0:n0+BN32],
// zeros past kw: one value a thread, consecutive threads on consecutive
// channels (two float4 loads a thread ran slower at 8x8 and 16x16;
// PERF.md)
__device__ void load_weights_f32(float* wts, const float* __restrict__ w, const Geom& g, int di,
                                 int dj0, int gw, int c0, int n0) {
  for (int e = threadIdx.x; e < gw * BK * BN32; e += THREADS) {
    const int n = e % BN32, row = e / BN32;  // (dj - dj0) * BK + k
    const int dj = dj0 + row / BK, c = c0 + row % BK, on = n0 + n;
    wts[row * LDB32 + n] = (dj < g.kw && c < g.cin && on < g.cout)
                               ? w[((size_t)(di * g.kw + dj) * g.cin + c) * g.cout + on]
                               : 0.f;
  }
}

// f32: thread owns 8 pixels x 4 output channels, plain FMA. The taps run in
// G's groups (a single group up to MAX_K a side); the staged patch covers
// one group's halo.
__global__ void __launch_bounds__(THREADS)
conv_valid_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
               Geom g, Groups G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom pg = group_patch(g, G);
  float* patch = reinterpret_cast<float*>(smem);
  const int pw = patch_w(pg);
  float* wts = patch + patch_f32_floats(pg);

  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z / g.n_ntiles, n0 = (blockIdx.z % g.n_ntiles) * BN32;
  const int tn = threadIdx.x % 16, tp = threadIdx.x / 16;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < g.cin; c0 += BK)
    for (int qi = 0; qi < G.ngh; ++qi)
      for (int qj = 0; qj < G.ngw; ++qj) {
        __syncthreads();
        // f32 patch rows are BK + 1 wide (bank spread), so stage element-wise
        const int total = patch_h(pg) * pw * BK;
        for (int e = threadIdx.x; e < total; e += THREADS) {
          const int k = e % BK, pix = e / BK;
          const int gy = y0 + qi * G.gh + pix / pw, gx = x0 + qj * G.gw + pix % pw, c = c0 + k;
          patch[pix * LDA32 + k] = (gy < g.hp && gx < g.wp && c < g.cin)
                                       ? x[((size_t)(b * g.hp + gy) * g.wp + gx) * g.cin + c]
                                       : 0.f;
        }
        // taps past kh or kw in the last groups are skipped
        for (int di = 0; di < G.gh && qi * G.gh + di < g.kh; ++di) {
          __syncthreads();
          load_weights_f32(wts, w, g, qi * G.gh + di, qj * G.gw, G.gw, c0, n0);
          __syncthreads();
          for (int dj = 0; dj < G.gw && qj * G.gw + dj < g.kw; ++dj) {
            for (int k = 0; k < BK; ++k) {
              const float4 bv =
                  *reinterpret_cast<const float4*>(wts + (dj * BK + k) * LDB32 + tn * 4);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int p = tp * 8 + i;
                const float a = patch[((p / TW + di) * pw + p % TW + dj) * LDA32 + k];
                acc[i][0] = fmaf(a, bv.x, acc[i][0]);
                acc[i][1] = fmaf(a, bv.y, acc[i][1]);
                acc[i][2] = fmaf(a, bv.z, acc[i][2]);
                acc[i][3] = fmaf(a, bv.w, acc[i][3]);
              }
            }
          }
        }
      }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = tp * 8 + i;
    const int oy = y0 + p / TW, ox = x0 + p % TW;
    if (oy >= g.ho || ox >= g.wo) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int on = n0 + tn * 4 + j;
      if (on < g.cout) out[((size_t)(b * g.ho + oy) * g.wo + ox) * g.cout + on] = acc[i][j];
    }
  }
}

}  // namespace conv
}  // namespace credit

using namespace credit;

// x (n, hp, wp, cin), w (kh, kw, cin, cout), out (n, hp-kh+1, wp-kw+1, cout),
// all contiguous, 16-byte aligned and of one dtype (kF32 or kBF16);
// kh * kw >= 2 (a 1x1 conv is a plain GEMM), any kh and kw. bf16: cin and
// cout multiples of 8, the wrapper's plan of bn (64, 128, 192 or 256) output
// channels and tw (16, 32 or 64) output columns a block; f32: bn 64, tw 16.
extern "C" int credit_conv_valid(const void* x, const void* w, void* out, int dtype, int n, int hp,
                                 int wp, int cin, int kh, int kw, int cout, int bn, int tw,
                                 void* stream) {
  using namespace credit::conv;
  if (kh < 1 || kw < 1 || kh * kw < 2 || hp < kh || wp < kw || n < 1 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ho = hp - kh + 1, wo = wp - kw + 1;
  if (dtype == kBF16) {
    if (cin % 8 || cout % 8 || (tw != 16 && tw != 32 && tw != 64)) return (int)cudaErrorInvalidValue;
    const int th = 128 / tw;
    TcGeom g{kh, kw, (cin + KS - 1) / KS, ho, wo, cout, tw == 16 ? 4 : (tw == 32 ? 5 : 6),
             (wo + tw - 1) / tw};
    const int nyt = (ho + th - 1) / th;
    CUtensorMap tx, tk;
    const cuuint64_t xd[4] = {(cuuint64_t)cin, (cuuint64_t)wp, (cuuint64_t)hp, (cuuint64_t)n};
    const cuuint64_t xs[3] = {(cuuint64_t)cin * 2, (cuuint64_t)wp * cin * 2,
                              (cuuint64_t)hp * wp * cin * 2};
    const cuuint32_t xb[4] = {KS, (cuuint32_t)tw, (cuuint32_t)th, 1};
    const cuuint64_t kd[3] = {(cuuint64_t)cout, (cuuint64_t)cin, (cuuint64_t)kh * kw};
    const cuuint64_t ks[2] = {(cuuint64_t)cout * 2, (cuuint64_t)cin * cout * 2};
    const cuuint32_t kb[3] = {64, KS, 1};
    if (!bf16_map(&tx, x, 4, xd, xs, xb) || !bf16_map(&tk, w, 3, kd, ks, kb))
      return (int)cudaErrorInvalidValue;
    cudaError_t err;
    switch (bn) {
      case 64: err = launch_bf16<64>(tx, tk, out, g, n, nyt, s); break;
      case 128: err = launch_bf16<128>(tx, tk, out, g, n, nyt, s); break;
      case 192: err = launch_bf16<192>(tx, tk, out, g, n, nyt, s); break;
      case 256: err = launch_bf16<256>(tx, tk, out, g, n, nyt, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)err;
  }
  if (dtype != kF32 || bn != BN32 || tw != TW) return (int)cudaErrorInvalidValue;
  Geom g{hp, wp, cin, kh, kw, cout, ho, wo, (cout + BN32 - 1) / BN32};
  // the fewest groups of at most MAX_K taps a side, as even as they go
  const int ngh = (kh + MAX_K - 1) / MAX_K, ngw = (kw + MAX_K - 1) / MAX_K;
  const Groups G{(kh + ngh - 1) / ngh, (kw + ngw - 1) / ngw, ngh, ngw};
  const dim3 grid((wo + TW - 1) / TW, (ho + TH - 1) / TH, n * g.n_ntiles);
  const size_t smem = smem_f32(group_patch(g, G));
  cudaFuncSetAttribute(conv_valid_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  conv_valid_f32<<<grid, THREADS, smem, s>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(w),
                                             static_cast<float*>(out), g, G);
  return (int)cudaGetLastError();
}
