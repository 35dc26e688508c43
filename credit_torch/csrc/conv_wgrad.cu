// Weight gradient of the stride-1 VALID conv, NHWC x, NHWC gy -> f32 HWIO:
//   gk[di, dj, c, o] = sum_{n, y, x} x[n, y + di, x + dj, c] * gy[n, y, x, o].
//
// Replaces credit_tpu/ops/pallas_conv.py conv2d_wgrad (the pallas_call at
// :320). In the port's training step it gives the kernel gradient of every
// conv with kh*kw > 1: the four patch embeds (8x8 after space-to-depth at
// stage 0, 2x2 at stages 1-3), the six 3x3 decoder residual convs and the
// head's 3x3 phase conv.
//
// Bound on the H100: operations. The stage-0 embed's gradient is an 8x8 x
// 240 x 176 product over 408x728 pixels, 1.61 TFLOP against ~0.25 GB of
// traffic, far above the card's ~295 FLOP/byte ridge. bf16 runs the products
// on the tensor cores (mma.sync m16n8k16, f32 accumulators); f32 is FMA.
//
// Design: a GEMM per tap, (Cin x pixels) . (pixels x Cout), with the pixels
// as the contraction. A block owns a 64 (Cin) x 64 (Cout) tile of a group of
// TR x TC neighbouring taps and a share of the pixels (split-K). It walks its
// pixels in chunks of one output row segment: per chunk the gy segment and
// the TR input row strips the group's taps read (TC - 1 columns of halo)
// arrive once by cp.async through a 3-deep ring, and every tap of the group
// is a pointer shift into the strips, so one gy fragment feeds TR*TC
// products. The TPU kernel summed its tiles in order into one VMEM block;
// here blocks run in parallel, so each split writes its own partial gk to a
// scratch buffer (the caller's, `credit_conv_wgrad_workspace` bytes) and a
// second pass adds the splits in a fixed order: the result does not change
// from run to run. Ragged pixels, channels and taps are masked by zeros on
// load and by bounds on store. The TPU kernel's lane tricks (the f32 roll,
// gy padded to the lane tile, the Cin sublane pad) have no counterpart.
#include <algorithm>

#include "common.cuh"

namespace credit {
namespace wgrad {

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 64;        // input channels per block
constexpr int BN = 64;        // output channels per block
constexpr int P = 64;         // pixels per chunk (bf16)
constexpr int NS = 3;         // chunk ring depth
constexpr int LDS = BM + 8;   // shared row stride (BM == BN): 144 bytes, ldmatrix conflict-free

struct Geom {
  int n, hp, wp, cin, kh, kw, cout, ho, wo;
  int nxc;      // chunks per output row
  int nchunks;  // chunks in all
  int n_ct, n_ot, ngc;  // channel tiles, output tiles, tap groups per kernel row
  int splits;
};

// chunk ci -> (image, output row, first output column)
__device__ __forceinline__ void chunk_at(const Geom& g, int ci, int p, int& b, int& y, int& x0) {
  x0 = (ci % g.nxc) * p;
  y = (ci / g.nxc) % g.ho;
  b = ci / (g.nxc * g.ho);
}

// ---------------------------------------------------------------- bf16
template <int TR, int TC>
struct Plan {
  static constexpr int SW = P + TC - 1;                  // strip width in pixels
  static constexpr int G_ELEMS = P * LDS;                // gy segment
  static constexpr int X_ELEMS = TR * SW * LDS;          // input strips
  static constexpr int STAGE = G_ELEMS + X_ELEMS;
  static constexpr size_t SMEM = (size_t)NS * STAGE * sizeof(__nv_bfloat16);
};

// 8 consecutive channels from src (count valid), zero past it, into dst
__device__ __forceinline__ void load8(__nv_bfloat16* dst, const __nv_bfloat16* src, int valid,
                                      bool vec) {
  if (valid >= 8 && vec) {
    cp_async16(dst, src);
  } else if (valid <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = i < valid ? src[i] : __float2bfloat16(0.f);
  }
}

template <int TR, int TC>
__device__ void load_chunk(__nv_bfloat16* stage, const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ gy, const Geom& g, int ci, int c0,
                           int o0, int di0, int dj0, bool vec_x, bool vec_g) {
  using Pl = Plan<TR, TC>;
  int b, y, x0;
  chunk_at(g, ci, P, b, y, x0);
  __nv_bfloat16* sg = stage;
  __nv_bfloat16* sx = stage + Pl::G_ELEMS;
  for (int i = threadIdx.x; i < P * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8), v = (i % (BN / 8)) * 8;
    const int xx = x0 + r;
    const bool in = xx < g.wo;
    const __nv_bfloat16* src = gy + ((size_t)(b * g.ho + y) * g.wo + (in ? xx : 0)) * g.cout + o0 + v;
    load8(sg + r * LDS + v, src, in ? g.cout - o0 - v : 0, vec_g);
  }
  for (int i = threadIdx.x; i < TR * Pl::SW * (BM / 8); i += THREADS) {
    const int v = (i % (BM / 8)) * 8, j = (i / (BM / 8)) % Pl::SW, tr = i / (BM / 8 * Pl::SW);
    const int yy = y + di0 + tr, xx = x0 + dj0 + j;
    const bool in = yy < g.hp && xx < g.wp;
    const __nv_bfloat16* src =
        x + ((size_t)(b * g.hp + (in ? yy : 0)) * g.wp + (in ? xx : 0)) * g.cin + c0 + v;
    load8(sx + (tr * Pl::SW + j) * LDS + v, src, in ? g.cin - c0 - v : 0, vec_x);
  }
}

// Warp (wm, wn) of 4 x 2 owns channels [16 wm, 16 wm + 16) and outputs
// [32 wn, 32 wn + 32) of the block tile, for each of the TR*TC taps.
template <int TR, int TC>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gy,
           float* __restrict__ part, Geom g, bool vec_x, bool vec_g) {
  using Pl = Plan<TR, TC>;
  constexpr int TG = TR * TC;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  int t = blockIdx.x;
  const int o0 = (t % g.n_ot) * BN;
  t /= g.n_ot;
  const int c0 = (t % g.n_ct) * BM;
  t /= g.n_ct;
  const int di0 = (t / g.ngc) * TR, dj0 = (t % g.ngc) * TC;
  const int split = blockIdx.y;
  const int per = (g.nchunks + g.splits - 1) / g.splits;
  const int ch0 = split * per, nch = max(0, min(g.nchunks, ch0 + per) - ch0);

  float acc[TG][4][4];
#pragma unroll
  for (int q = 0; q < TG; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;

  for (int s = 0; s < NS - 1; ++s) {
    if (s < nch)
      load_chunk<TR, TC>(ring + s * Pl::STAGE, x, gy, g, ch0 + s, c0, o0, di0, dj0, vec_x, vec_g);
    cp_async_commit();
  }
  for (int s = 0; s < nch; ++s) {
    cp_async_wait<NS - 2>();  // chunk s has landed
    __syncthreads();          // for every thread, and chunk s - 1 is consumed
    if (s + NS - 1 < nch)
      load_chunk<TR, TC>(ring + (s + NS - 1) % NS * Pl::STAGE, x, gy, g, ch0 + s + NS - 1, c0, o0,
                         di0, dj0, vec_x, vec_g);
    cp_async_commit();
    const __nv_bfloat16* sg = ring + (s % NS) * Pl::STAGE;
    const __nv_bfloat16* sx = sg + Pl::G_ELEMS;
    // B = gy (pixels x outputs, row-major): transposed ldmatrix, lane l
    // addresses pixel (l % 8) + ((l / 8) % 2) * 8 at output (l / 16) * 8.
    // A = x^T (channels x pixels) from the [pixel][channel] strips:
    // transposed ldmatrix, lane l addresses pixel (l % 8) + (l / 16) * 8 at
    // channel ((l / 8) % 2) * 8; a tap (tr, tc) shifts the strip and pixel.
    const __nv_bfloat16* bptr =
        sg + ((lane % 8) + ((lane / 8) % 2) * 8) * LDS + wn * 32 + (lane / 16) * 8;
    const __nv_bfloat16* aptr =
        sx + ((lane % 8) + (lane / 16) * 8) * LDS + wm * 16 + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < P; kk += 16) {
      uint32_t bf[2][4];
      ldmatrix_x4_trans(bf[0], bptr + kk * LDS);
      ldmatrix_x4_trans(bf[1], bptr + kk * LDS + 16);
#pragma unroll
      for (int tr = 0; tr < TR; ++tr)
#pragma unroll
        for (int tc = 0; tc < TC; ++tc) {
          uint32_t af[4];
          ldmatrix_x4_trans(af, aptr + (tr * Pl::SW + kk + tc) * LDS);
          float(&a)[4][4] = acc[tr * TC + tc];
          mma_bf16(a[0], af, bf[0][0], bf[0][1]);
          mma_bf16(a[1], af, bf[0][2], bf[0][3]);
          mma_bf16(a[2], af, bf[1][0], bf[1][1]);
          mma_bf16(a[3], af, bf[1][2], bf[1][3]);
        }
    }
  }

  // acc[q][j]: channels c0 + 16 wm + lane / 4 (+ 8), outputs
  // o0 + 32 wn + 8 j + 2 (lane % 4) (+ 1)
  const size_t total = (size_t)g.kh * g.kw * g.cin * g.cout;
  float* dst = part + (size_t)split * total;
#pragma unroll
  for (int q = 0; q < TG; ++q) {
    const int di = di0 + q / TC, dj = dj0 + q % TC;
    if (di >= g.kh || dj >= g.kw) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + wm * 16 + lane / 4 + (e / 2) * 8;
        const int o = o0 + wn * 32 + j * 8 + 2 * (lane % 4) + e % 2;
        if (c < g.cin && o < g.cout)
          dst[((size_t)(di * g.kw + dj) * g.cin + c) * g.cout + o] = acc[q][j][e];
      }
  }
}

// ---------------------------------------------------------------- f32
constexpr int P32 = 32;  // pixels per chunk

// thread (tm, tn) of 16 x 16 owns channels 4 tm.. and outputs 4 tn.., per tap
template <int TR, int TC>
__global__ void __launch_bounds__(THREADS)
wgrad_f32(const float* __restrict__ x, const float* __restrict__ gy, float* __restrict__ part,
          Geom g) {
  constexpr int TG = TR * TC, SW = P32 + TC - 1;
  __shared__ __align__(16) float sg[P32][BN];
  __shared__ __align__(16) float sx[TR][SW][BM];
  int t = blockIdx.x;
  const int o0 = (t % g.n_ot) * BN;
  t /= g.n_ot;
  const int c0 = (t % g.n_ct) * BM;
  t /= g.n_ct;
  const int di0 = (t / g.ngc) * TR, dj0 = (t % g.ngc) * TC;
  const int split = blockIdx.y;
  const int per = (g.nchunks + g.splits - 1) / g.splits;
  const int ch0 = split * per, ch1 = min(g.nchunks, ch0 + per);
  const int tn = threadIdx.x % 16, tm = threadIdx.x / 16;

  float acc[TG][4][4];
#pragma unroll
  for (int q = 0; q < TG; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;

  for (int ci = ch0; ci < ch1; ++ci) {
    int b, y, x0;
    chunk_at(g, ci, P32, b, y, x0);
    __syncthreads();
    for (int i = threadIdx.x; i < P32 * BN; i += THREADS) {
      const int r = i / BN, o = i % BN, xx = x0 + r;
      sg[r][o] = (xx < g.wo && o0 + o < g.cout)
                     ? gy[((size_t)(b * g.ho + y) * g.wo + xx) * g.cout + o0 + o]
                     : 0.f;
    }
    for (int i = threadIdx.x; i < TR * SW * BM; i += THREADS) {
      const int c = i % BM, j = (i / BM) % SW, tr = i / (BM * SW);
      const int yy = y + di0 + tr, xx = x0 + dj0 + j;
      sx[tr][j][c] = (yy < g.hp && xx < g.wp && c0 + c < g.cin)
                         ? x[((size_t)(b * g.hp + yy) * g.wp + xx) * g.cin + c0 + c]
                         : 0.f;
    }
    __syncthreads();
    for (int p = 0; p < P32; ++p) {
      const float4 bv = *reinterpret_cast<const float4*>(&sg[p][tn * 4]);
#pragma unroll
      for (int tr = 0; tr < TR; ++tr)
#pragma unroll
        for (int tc = 0; tc < TC; ++tc) {
          const float4 av = *reinterpret_cast<const float4*>(&sx[tr][p + tc][tm * 4]);
          const float a[4] = {av.x, av.y, av.z, av.w}, bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[tr * TC + tc][i][j] = fmaf(a[i], bb[j], acc[tr * TC + tc][i][j]);
        }
    }
  }
  const size_t total = (size_t)g.kh * g.kw * g.cin * g.cout;
  float* dst = part + (size_t)split * total;
#pragma unroll
  for (int q = 0; q < TG; ++q) {
    const int di = di0 + q / TC, dj = dj0 + q % TC;
    if (di >= g.kh || dj >= g.kw) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tm * 4 + i, o = o0 + tn * 4 + j;
        if (c < g.cin && o < g.cout)
          dst[((size_t)(di * g.kw + dj) * g.cin + c) * g.cout + o] = acc[q][i][j];
      }
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

// The tap group of a kernel: a kernel row of 3 for 3-wide kernels, 2x2 for
// 2x2 (and smaller), otherwise rows of 4 taps (the 8x8 embed).
inline void tap_group(int kh, int kw, int& tr, int& tc) {
  if (kh <= 2 && kw <= 2) {
    tr = 2, tc = 2;
  } else if (kw == 3) {
    tr = 1, tc = 3;
  } else {
    tr = 1, tc = 4;
  }
}

// Geometry and the split count: enough blocks for ~4 waves of two per SM,
// and at least 8 chunks a split.
inline Geom plan(int dtype, int n, int hp, int wp, int cin, int kh, int kw, int cout) {
  Geom g{};
  g.n = n, g.hp = hp, g.wp = wp, g.cin = cin, g.kh = kh, g.kw = kw, g.cout = cout;
  g.ho = hp - kh + 1, g.wo = wp - kw + 1;
  const int p = dtype == kBF16 ? P : P32;
  g.nxc = (g.wo + p - 1) / p;
  g.nchunks = n * g.ho * g.nxc;
  int tr, tc;
  tap_group(kh, kw, tr, tc);
  g.ngc = (kw + tc - 1) / tc;
  g.n_ct = (cin + BM - 1) / BM, g.n_ot = (cout + BN - 1) / BN;
  const int tiles = g.n_ct * g.n_ot * g.ngc * ((kh + tr - 1) / tr);
  int s = (4 * 2 * 132 + tiles - 1) / tiles;
  s = std::min(s, std::max(1, g.nchunks / 8));
  g.splits = std::max(1, s);
  return g;
}

template <int TR, int TC>
void launch(int dtype, const void* x, const void* gy, float* part, const Geom& g, bool vec_x,
            bool vec_g, cudaStream_t s) {
  const dim3 grid(g.n_ot * g.n_ct * g.ngc * ((g.kh + TR - 1) / TR), g.splits);
  if (dtype == kBF16) {
    const size_t smem = Plan<TR, TC>::SMEM;
    cudaFuncSetAttribute(wgrad_bf16<TR, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    wgrad_bf16<TR, TC><<<grid, THREADS, smem, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                    static_cast<const __nv_bfloat16*>(gy), part, g,
                                                    vec_x, vec_g);
  } else {
    wgrad_f32<TR, TC><<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(gy), part, g);
  }
}

}  // namespace wgrad
}  // namespace credit

using namespace credit;

// Bytes of scratch `credit_conv_wgrad` needs for these shapes (0 when one
// split suffices).
extern "C" long long credit_conv_wgrad_workspace(int dtype, int n, int hp, int wp, int cin,
                                                 int kh, int kw, int cout) {
  if (hp < kh || wp < kw || kh < 1 || kw < 1) return 0;
  const wgrad::Geom g = wgrad::plan(dtype, n, hp, wp, cin, kh, kw, cout);
  return g.splits > 1 ? (long long)g.splits * kh * kw * cin * cout * 4 : 0;
}

// x (n, hp, wp, cin), gy (n, hp-kh+1, wp-kw+1, cout), one dtype (kF32 or
// kBF16), contiguous and 16-byte aligned; gk (kh, kw, cin, cout) f32;
// work: credit_conv_wgrad_workspace bytes.
extern "C" int credit_conv_wgrad(const void* x, const void* gy, void* gk, void* work, int dtype,
                                 int n, int hp, int wp, int cin, int kh, int kw, int cout,
                                 void* stream) {
  using namespace credit::wgrad;
  if (n < 1 || kh < 1 || kw < 1 || hp < kh || wp < kw || cin < 1 || cout < 1 ||
      (dtype != kBF16 && dtype != kF32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = plan(dtype, n, hp, wp, cin, kh, kw, cout);
  float* part = g.splits > 1 ? static_cast<float*>(work) : static_cast<float*>(gk);
  const bool vec_x = cin % 8 == 0, vec_g = cout % 8 == 0;
  int tr, tc;
  tap_group(kh, kw, tr, tc);
  if (tr == 2)
    launch<2, 2>(dtype, x, gy, part, g, vec_x, vec_g, s);
  else if (tc == 3)
    launch<1, 3>(dtype, x, gy, part, g, vec_x, vec_g, s);
  else
    launch<1, 4>(dtype, x, gy, part, g, vec_x, vec_g, s);
  if (g.splits > 1) {
    const size_t total = (size_t)kh * kw * cin * cout;
    const int blocks = (int)std::min<size_t>((total + 255) / 256, 4096);
    sum_splits<<<blocks, 256, 0, s>>>(part, static_cast<float*>(gk), total, g.splits);
  }
  return (int)cudaGetLastError();
}
