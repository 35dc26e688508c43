// Stride-1 VALID 2-D convolution, NHWC input x HWIO kernel -> NHWC output,
// f32 accumulation, output in the input dtype.
//
// Replaces credit_tpu/ops/pallas_conv.py conv2d_valid (_forward, the
// pallas_call at :174). In the port it carries every patch embed (after the
// space-to-depth rewrite), every 3x3 decoder residual conv and the final
// 3x3 depth-to-space phase conv.
//
// Bound on the H100: operations. The flagship's stage-0 embed is an 8x8
// conv over 240 channels to 176 at 408x728 outputs, ~1.6 TFLOP against
// ~0.25 GB of traffic, far above the card's ~295 FLOP/byte ridge. So the
// bf16 path runs its products on the tensor cores (mma.sync m16n8k16, f32
// accumulators in registers). The f32 path is plain FMA.
//
// Design: implicit GEMM. A block owns TH x TW output pixels x BN output
// channels. For each chunk of BK input channels it stages the input patch
// with its (kh-1, kw-1) halo in shared memory once and runs every tap from
// it, so each input element is read from device memory once per chunk
// instead of kh*kw times. bf16: a warp owns 2 output rows of 16 pixels x
// BN/2 channels, so per 16 channels of K two ldmatrix loads of the patch
// (rows addressed per lane, shifted by the tap) and BN/32 of the weights
// feed BN/4 products. One pipeline stage is one (chunk, tap): that tap's
// BK x BN weight slice arrives by cp.async through a 4-deep ring, three
// stages ahead of its products, and the chunk's patch through 3 buffers, in
// ~110 KB so that two blocks share an SM. BN (64, 96 or 128) is picked from
// Cout to waste the fewest padded channels. Ragged edges (rows, columns,
// channels, output channels) are masked by the block itself: out-of-range
// input reads as zero and out-of-range outputs are not stored. The TPU
// kernel's sublane padding, f32 column rolls and two-ref halo trick have no
// counterpart here.
//
// Kernels taller or wider than MAX_K (the conv bench's 32x32/s2 embed is a
// 16x16 conv after space-to-depth) run their taps in ngh x ngw groups of
// gh x gw <= 8x8 (as even as they go; taps past kh or kw in the last groups
// are skipped). The staged patch covers one group's halo, so shared memory
// stays at the 8x8 plan, and every tap of every group adds into the same
// f32 accumulators, rounded to the output dtype once. The f32 kernel loops
// over the groups itself (one group up to 8x8). bf16 has a grouped kernel
// of its own, whose pipeline stage is one (chunk, group, tap), walked by a
// cursor without divisions, at BN = 64 so that two blocks share an SM and
// the accumulators stay in registers: folding the groups into the 8x8
// kernel slowed it (per-stage divisions, more registers; PERF.md).
#include "common.cuh"

namespace credit {
namespace conv {

constexpr int TH = 8;         // output rows per block
constexpr int TW = 16;        // output columns per block (one m16 tile)
constexpr int BK = 32;        // input channels per staged chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_K = 8;      // largest kh / kw of one tap group

struct Geom {
  int hp, wp, cin, kh, kw, cout, ho, wo, n_ntiles;
};

__host__ __device__ inline int patch_h(const Geom& g) { return TH + g.kh - 1; }
__host__ __device__ inline int patch_w(const Geom& g) { return TW + g.kw - 1; }

// ---------------------------------------------------------------- bf16
constexpr int LDA = BK + 8;  // patch channel stride: 80 bytes, ldmatrix conflict-free
constexpr int NW = 4;        // weight-slice ring
constexpr int NP = 3;        // patch buffers

__host__ __device__ inline int patch_elems(const Geom& g) { return patch_h(g) * patch_w(g) * LDA; }
template <int BN>
__host__ __device__ inline int slice_elems() { return BK * (BN + 8); }

template <int BN>
__host__ inline size_t smem_bf16(const Geom& g) {
  return ((size_t)NP * patch_elems(g) + (size_t)NW * slice_elems<BN>()) * sizeof(__nv_bfloat16);
}

// The (TH+kh-1) x (TW+kw-1) x BK patch of channel chunk c0: aligned 8-channel
// groups by cp.async, the rest (and zeros past the edges) by plain stores.
__device__ void load_patch(__nv_bfloat16* patch, const __nv_bfloat16* __restrict__ x,
                           const Geom& g, int b, int y0, int x0, int c0, bool vec) {
  const int pw = patch_w(g);
  const int groups = patch_h(g) * pw * (BK / 8);
  for (int gi = threadIdx.x; gi < groups; gi += THREADS) {
    const int pix = gi / (BK / 8), cg = gi % (BK / 8);
    const int gy = y0 + pix / pw, gx = x0 + pix % pw, c = c0 + cg * 8;
    __nv_bfloat16* dst = patch + pix * LDA + cg * 8;
    if (gy >= g.hp || gx >= g.wp || c >= g.cin) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const __nv_bfloat16* src = x + ((size_t)(b * g.hp + gy) * g.wp + gx) * g.cin + c;
    if (vec) {  // cin % 8 == 0: the 8 channels are in range and aligned
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = (c + i < g.cin) ? src[i] : __float2bfloat16(0.f);
    }
  }
}

// The BK x BN weight slice w[tap, c0:c0+BK, n0:n0+BN], row stride BN + 8.
template <int BN>
__device__ void load_slice(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ w, const Geom& g,
                           int tap, int c0, int n0, bool vec) {
  for (int gi = threadIdx.x; gi < BK * (BN / 8); gi += THREADS) {
    const int k = gi / (BN / 8), n = n0 + (gi % (BN / 8)) * 8, c = c0 + k;
    __nv_bfloat16* d = dst + k * (BN + 8) + (n - n0);
    if (c >= g.cin || n >= g.cout) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const __nv_bfloat16* src = w + ((size_t)tap * g.cin + c) * g.cout + n;
    if (vec && n + 8 <= g.cout) {  // cout % 8 == 0: 8 aligned values
      cp_async16(d, src);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = (n + i < g.cout) ? src[i] : __float2bfloat16(0.f);
    }
  }
}

// one tap's products over one channel chunk: the warp's 2 rows of 16 pixels
// (A, rows addressed per lane) by its BN/2 output channels (B)
template <int BN>
__device__ __forceinline__ void tap_products(float (&acc)[2][BN / 16][4], const __nv_bfloat16* a,
                                             const __nv_bfloat16* bw, int pw) {
  constexpr int NF = BN / 16, LDB = BN + 8;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], a + i * pw * LDA + kk);
#pragma unroll
    for (int jp = 0; jp < NF / 2; ++jp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, bw + kk * LDB + jp * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
        mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// acc[i][j] holds pixels lane/4 and lane/4 + 8 of output row y0 + 2wm + i,
// channels n0 + wn BN/2 + 8j + 2 (lane % 4) and the next
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[2][BN / 16][4],
                                           __nv_bfloat16* __restrict__ out, const Geom& g, int b,
                                           int y0, int x0, int n0) {
  constexpr int NF = BN / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oy = y0 + 2 * wm + i;
    if (oy >= g.ho) continue;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int on = n0 + wn * (BN / 2) + j * 8 + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = x0 + lane / 4 + 8 * h;
        if (ox >= g.wo) continue;
        __nv_bfloat16* o = out + ((size_t)(b * g.ho + oy) * g.wo + ox) * g.cout + on;
        if (on + 1 < g.cout && g.cout % 2 == 0) {
          *reinterpret_cast<uint32_t*>(o) = pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (on < g.cout) o[0] = __float2bfloat16(acc[i][j][2 * h]);
          if (on + 1 < g.cout) o[1] = __float2bfloat16(acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

// Warp (wm, wn) owns output rows 2wm, 2wm+1 of the block (16 pixels each)
// and channels [wn BN/2, (wn+1) BN/2): NF = BN/16 n8 tiles.
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv_valid_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, Geom g, bool vec_in, bool vec_out) {
  constexpr int NF = BN / 16, LDB = BN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* patches = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = patches + NP * patch_elems(g);
  const int pw = patch_w(g);
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z / g.n_ntiles, n0 = (blockIdx.z % g.n_ntiles) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int taps = g.kh * g.kw;
  const int total = (g.cin + BK - 1) / BK * taps;  // stages: (chunk, tap)

  // stage s = (chunk s / taps, tap s % taps); a chunk's first stage also
  // brings its patch. A slot is rewritten 4 stages later, a patch buffer 3
  // chunks later: both after the barrier that follows their last reader
  // (taps >= 2).
  auto load_stage = [&](int s) {
    const int c = s / taps, tap = s % taps;
    if (tap == 0)
      load_patch(patches + (c % NP) * patch_elems(g), x, g, b, y0, x0, c * BK, vec_in);
    load_slice<BN>(ring + (s % NW) * slice_elems<BN>(), w, g, tap, c * BK, n0, vec_out);
  };

  float acc[2][NF][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s = 0; s < NW - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<NW - 2>();  // stage s has landed
    __syncthreads();          // for every thread, and stage s - 1 is consumed
    if (s + NW - 1 < total) load_stage(s + NW - 1);
    cp_async_commit();
    const int tap = s % taps, di = tap / g.kw, dj = tap % g.kw;
    // lane l addresses A row l % 16 (a pixel) at channel offset (l / 16) * 8,
    // and B row (l % 8) + ((l / 8) % 2) * 8 at column offset (l / 16) * 8
    const __nv_bfloat16* a = patches + (s / taps % NP) * patch_elems(g) +
                             ((2 * wm + di) * pw + lane % 16 + dj) * LDA + (lane / 16) * 8;
    const __nv_bfloat16* bw = ring + (s % NW) * slice_elems<BN>() +
                              ((lane % 8) + ((lane / 8) % 2) * 8) * LDB + wn * (BN / 2) +
                              (lane / 16) * 8;
    tap_products<BN>(acc, a, bw, pw);
  }
  store_tile<BN>(acc, out, g, b, y0, x0, n0);
}

template <int BN>
void launch_bf16(const void* x, const void* w, void* out, Geom g, int n, bool vec_in,
                 bool vec_out, cudaStream_t s) {
  g.n_ntiles = (g.cout + BN - 1) / BN;
  const dim3 grid((g.wo + TW - 1) / TW, (g.ho + TH - 1) / TH, n * g.n_ntiles);
  const size_t smem = smem_bf16<BN>(g);
  cudaFuncSetAttribute(conv_valid_bf16<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  conv_valid_bf16<BN><<<grid, THREADS, smem, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<const __nv_bfloat16*>(w),
                                                  static_cast<__nv_bfloat16*>(out), g, vec_in,
                                                  vec_out);
}

// the channel tile of 64, 96 or 128 that pads cout the least (the larger
// on a tie: fewer blocks re-read the patch)
inline int pick_bn(int cout) {
  const int bns[3] = {128, 96, 64};
  int best = bns[0];
  for (int bn : bns)
    if ((cout + bn - 1) / bn * bn < (cout + best - 1) / best * best) best = bn;
  return best;
}

// ---------------------------------------------------------------- groups
// The tap groups of a kernel: ngh x ngw groups of gh x gw (a single group
// up to MAX_K a side).
struct Groups {
  int gh, gw, ngh, ngw;
};

// The staged patch covers one group's halo.
__host__ __device__ inline Geom group_patch(Geom g, const Groups& G) {
  g.kh = G.gh, g.kw = G.gw;
  return g;
}

// A pipeline stage of the grouped bf16 kernel, stepped without divisions:
// channel chunk c, group (qi, qj), tap (ti, tj) of the group, and p, the
// running count of staged patches.
struct Cursor {
  int c = 0, qi = 0, qj = 0, ti = 0, tj = 0, p = 0;

  __device__ void next(const Groups& G) {
    if (++tj < G.gw) return;
    tj = 0;
    if (++ti < G.gh) return;
    ti = 0;
    ++p;
    if (++qj < G.ngw) return;
    qj = 0;
    if (++qi < G.ngh) return;
    qi = 0;
    ++c;
  }
  __device__ int di(const Groups& G) const { return qi * G.gh + ti; }
  __device__ int dj(const Groups& G) const { return qj * G.gw + tj; }
};

constexpr int BNG = 64;  // the grouped bf16 kernel's output-channel tile

// As conv_valid_bf16 at BN = 64, one stage per (chunk, group, tap); a
// group's first stage brings its patch (taps >= 2 a group, as there).
__global__ void __launch_bounds__(THREADS, 2)
conv_valid_bf16_grouped(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, Geom g, Groups G, bool vec_in,
                        bool vec_out) {
  constexpr int BN = BNG, NF = BN / 16, LDB = BN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom pg = group_patch(g, G);
  __nv_bfloat16* patches = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = patches + NP * patch_elems(pg);
  const int pw = patch_w(pg);
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z / g.n_ntiles, n0 = (blockIdx.z % g.n_ntiles) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int total = (g.cin + BK - 1) / BK * G.ngh * G.ngw * G.gh * G.gw;

  auto load_stage = [&](const Cursor& k, int s) {
    if (k.ti == 0 && k.tj == 0)
      load_patch(patches + (k.p % NP) * patch_elems(pg), x, pg, b, y0 + k.qi * G.gh,
                 x0 + k.qj * G.gw, k.c * BK, vec_in);
    if (k.di(G) < g.kh && k.dj(G) < g.kw)
      load_slice<BN>(ring + (s % NW) * slice_elems<BN>(), w, g, k.di(G) * g.kw + k.dj(G),
                     k.c * BK, n0, vec_out);
  };

  float acc[2][NF][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  Cursor ld, cu;  // the stage being loaded, the stage being computed
  for (int s = 0; s < NW - 1; ++s) {
    if (s < total) {
      load_stage(ld, s);
      ld.next(G);
    }
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<NW - 2>();
    __syncthreads();
    if (s + NW - 1 < total) {
      load_stage(ld, s + NW - 1);
      ld.next(G);
    }
    cp_async_commit();
    // a tap past the kernel's edge in the last groups adds nothing
    if (cu.di(G) < g.kh && cu.dj(G) < g.kw) {
      const __nv_bfloat16* a = patches + (cu.p % NP) * patch_elems(pg) +
                               ((2 * wm + cu.ti) * pw + lane % 16 + cu.tj) * LDA + (lane / 16) * 8;
      const __nv_bfloat16* bw = ring + (s % NW) * slice_elems<BN>() +
                                ((lane % 8) + ((lane / 8) % 2) * 8) * LDB + wn * (BN / 2) +
                                (lane / 16) * 8;
      tap_products<BN>(acc, a, bw, pw);
    }
    cu.next(G);
  }
  store_tile<BN>(acc, out, g, b, y0, x0, n0);
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
// kh * kw >= 2 (a 1x1 conv is a plain GEMM), any kh and kw.
extern "C" int credit_conv_valid(const void* x, const void* w, void* out, int dtype, int n, int hp,
                                 int wp, int cin, int kh, int kw, int cout, void* stream) {
  using namespace credit::conv;
  if (kh < 1 || kw < 1 || kh * kw < 2 || hp < kh || wp < kw) return (int)cudaErrorInvalidValue;
  Geom g{hp, wp, cin, kh, kw, cout, hp - kh + 1, wp - kw + 1, 0};
  const bool vec_in = cin % 8 == 0, vec_out = cout % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the fewest groups of at most MAX_K taps a side, as even as they go
  const int ngh = (kh + MAX_K - 1) / MAX_K, ngw = (kw + MAX_K - 1) / MAX_K;
  const Groups G{(kh + ngh - 1) / ngh, (kw + ngw - 1) / ngw, ngh, ngw};
  const Geom pg = group_patch(g, G);
  if (dtype == kBF16 && ngh * ngw > 1) {
    g.n_ntiles = (cout + BNG - 1) / BNG;
    const dim3 grid((g.wo + TW - 1) / TW, (g.ho + TH - 1) / TH, n * g.n_ntiles);
    const size_t smem = smem_bf16<BNG>(pg);
    cudaFuncSetAttribute(conv_valid_bf16_grouped, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    conv_valid_bf16_grouped<<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), g, G, vec_in, vec_out);
  } else if (dtype == kBF16) {
    switch (pick_bn(cout)) {
      case 64: launch_bf16<64>(x, w, out, g, n, vec_in, vec_out, s); break;
      case 96: launch_bf16<96>(x, w, out, g, n, vec_in, vec_out, s); break;
      default: launch_bf16<128>(x, w, out, g, n, vec_in, vec_out, s); break;
    }
  } else if (dtype == kF32) {
    g.n_ntiles = (cout + BN32 - 1) / BN32;
    const dim3 grid((g.wo + TW - 1) / TW, (g.ho + TH - 1) / TH, n * g.n_ntiles);
    const size_t smem = smem_f32(pg);
    cudaFuncSetAttribute(conv_valid_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    conv_valid_f32<<<grid, THREADS, smem, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w),
                                               static_cast<float*>(out), g, G);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
