// Row-band VALID conv drafts: stride-1 VALID 2-D convolution, NHWC input x
// HWIO kernel -> NHWC output, f32 accumulation, output in the input dtype.
// The same function as kernel 2 (conv_valid.cu); these are benches of it
// (credit_torch/tools/bench_conv.py), and nothing in the models routes here.
//
//   credit_conv_band_dma  replaces tools/bench_pallas_conv.py make_pallas_conv
//                         (`run`, the pallas_call at :60): a manual DMA of a
//                         (TH + kh - 1)-row band, halo included, then every
//                         tap over the staged band.
//   credit_conv_band_halo replaces make_blocked_pallas_conv (`run`, :123): the
//                         input passed twice, a TH-row main block and a
//                         (kh - 1)-row halo block, and one f32 partial per
//                         column tap dj added into the sum shifted by dj.
//
// Bound on the H100: operations. The probes' shape, 8x8 over 240 channels
// to 176 at 408x728 outputs, is ~1.6 TFLOP against ~0.25 GB of traffic,
// so the bf16 products run on the tensor cores (mma.sync m16n8k16, f32
// accumulators in registers); f32 is plain FMA.
//
// Design. One block owns a band of TH output rows (the tools' TH, at most
// 32), TW = 16 output columns and BN output channels; warp w owns output
// rows w, w + 8, ... of the band. For each chunk of BK input channels the
// band with its halo, (TH + kh - 1) x (TW + kw - 1) pixels, is staged in
// shared memory (two buffers: chunk c + 1 arrives while chunk c computes)
// and every tap is a pointer shift into it, as in kernel 2. The weight slice
// of each (chunk, tap) streams through a 4-deep cp.async ring.
//   dma:  the band comes by cp.async.bulk copies (one per staged pixel: its
//         BK channels are contiguous in NHWC) that complete on an mbarrier
//         with their byte count, the Hopper counterpart of the TPU's
//         make_async_copy + semaphore wait. Taps run row-major, as the tool's.
//   halo: the main rows come from one pointer and the halo rows from a second
//         (the wrapper passes x twice, as the tool passes p twice), by
//         cp.async; taps run column-major, and each column tap dj sums its
//         kh row taps into its own f32 partial, which is then added into the
//         accumulator. The tool rolls that partial left by dj over the padded
//         width; here the shift is the partial's column offset in the band.
// Ragged edges (rows, columns, output rows past the band) are masked: pixels
// past the input read as zero and outputs past the edge are not stored.
#include <type_traits>

#include "common.cuh"

namespace credit {
namespace band {

constexpr int TW = 16;        // output columns per block
constexpr int THREADS = 256;  // 8 warps
constexpr int NW = 4;         // weight-slice ring
constexpr int MAX_TH = 32;    // 8 warps x 4 rows
constexpr int BAR_BYTES = 128;

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 32, LDA = 40;  // 80-byte pixel rows: ldmatrix conflict-free
};
template <>
struct Cfg<float> {
  static constexpr int BK = 16, LDA = 20;  // 80-byte pixel rows, 16-byte aligned
};

struct Geom {
  int hp, wp, cin, kh, kw, cout, ho, wo, th, bh, bw, n_ntiles;
};

template <typename T>
__host__ __device__ inline int band_elems(const Geom& g) {
  return g.bh * g.bw * Cfg<T>::LDA;
}
template <typename T, int BN>
__host__ __device__ constexpr int ldb() {
  return BN + 16 / (int)sizeof(T);
}
template <typename T, int BN>
__host__ __device__ constexpr int slice_elems() {
  return Cfg<T>::BK * ldb<T, BN>();
}
template <typename T, int BN>
__host__ inline size_t smem_bytes(const Geom& g) {
  return BAR_BYTES + (2 * (size_t)band_elems<T>(g) + (size_t)NW * slice_elems<T, BN>()) * sizeof(T);
}

// ------------------------------------------------------------ Hopper copies
// (mbarrier and bulk-copy helpers: common.cuh)
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

template <typename T>
__device__ __forceinline__ void zero16(T* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

// ------------------------------------------------------------ band staging
// dma: the chunk [c0, c0 + BK) of every band pixel, one bulk copy each;
// pixels past the input and channels past cin are zeroed by plain stores
// (other bytes than the copies'). One arrival (thread 0) carries the byte
// count; a copy may complete before it, which the barrier allows.
template <typename T>
__device__ void stage_band_bulk(T* buf, const T* __restrict__ x, const Geom& g, int b, int y0,
                                int x0, int c0, uint64_t* bar) {
  constexpr int BK = Cfg<T>::BK, LDA = Cfg<T>::LDA, V = 16 / sizeof(T);
  const int nc = min(BK, g.cin - c0);
  const uint32_t bytes = nc * sizeof(T);
  const int rows_in = max(0, min(g.bh, g.hp - y0)), cols_in = max(0, min(g.bw, g.wp - x0));
  fence_proxy_async();
  if (threadIdx.x == 0) mbar_expect_tx(bar, (uint32_t)(rows_in * cols_in) * bytes);
  for (int i = threadIdx.x; i < g.bh * g.bw; i += THREADS) {
    const int r = i / g.bw, col = i % g.bw;
    T* dst = buf + i * LDA;
    int from = 0;
    if (r < rows_in && col < cols_in) {
      bulk_g2s(dst, x + ((size_t)(b * g.hp + y0 + r) * g.wp + x0 + col) * g.cin + c0, bytes, bar);
      from = nc;
    }
    for (int k = from; k < BK; k += V) zero16(dst + k);
  }
}

// halo: the TH main rows from xm and the kh - 1 halo rows from xh, two
// separate copies, 16 bytes a cp.async (committed by the caller)
template <typename T>
__device__ void stage_rows(T* buf, const T* __restrict__ src, const Geom& g, int b, int y0, int x0,
                           int c0, int r0, int r1) {
  constexpr int BK = Cfg<T>::BK, LDA = Cfg<T>::LDA, V = 16 / sizeof(T);
  const int per_pix = BK / V;
  const int total = (r1 - r0) * g.bw * per_pix;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int pix = r0 * g.bw + i / per_pix, v = i % per_pix;
    const int gy = y0 + pix / g.bw, gx = x0 + pix % g.bw, c = c0 + v * V;
    T* dst = buf + pix * LDA + v * V;
    if (gy < g.hp && gx < g.wp && c < g.cin)
      cp_async16(dst, src + ((size_t)(b * g.hp + gy) * g.wp + gx) * g.cin + c);
    else
      zero16(dst);
  }
}

// The BK x BN weight slice w[tap, c0:c0+BK, n0:n0+BN] (cout % 8 == 0).
template <typename T, int BN>
__device__ void load_slice(T* dst, const T* __restrict__ w, const Geom& g, int tap, int c0, int n0) {
  constexpr int V = 16 / sizeof(T), BK = Cfg<T>::BK;
  for (int gi = threadIdx.x; gi < BK * (BN / V); gi += THREADS) {
    const int k = gi / (BN / V), n = n0 + (gi % (BN / V)) * V, c = c0 + k;
    T* d = dst + k * ldb<T, BN>() + (n - n0);
    if (c >= g.cin || n >= g.cout)
      zero16(d);
    else
      cp_async16(d, w + ((size_t)tap * g.cin + c) * g.cout + n);
  }
}

// ------------------------------------------------------------ per-warp tiles
// bf16: warp w owns output rows w + 8 i (i < RPW) of the band, 16 pixels
// each (one m16 tile), and all BN channels (BN / 8 n8 tiles)
template <int BN, int RPW>
struct TileBF16 {
  static constexpr int NF = BN / 8;
  float a[RPW][NF][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][j][e] = 0.f;
  }
  __device__ void add(const TileBF16& o) {
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][j][e] += o.a[i][j][e];
  }
  // products of one tap (di, dj) over one channel chunk
  __device__ void tap(const __nv_bfloat16* band, const __nv_bfloat16* slice, const Geom& g, int di,
                      int dj) {
    constexpr int BK = Cfg<__nv_bfloat16>::BK, LDA = Cfg<__nv_bfloat16>::LDA, LDB = ldb<__nv_bfloat16, BN>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // lane l addresses A row l % 16 (a pixel) at channel offset (l / 16) * 8,
    // and B row (l % 8) + ((l / 8) % 2) * 8 at column offset (l / 16) * 8
    const __nv_bfloat16* pa = band + ((warp + di) * g.bw + lane % 16 + dj) * LDA + (lane / 16) * 8;
    const __nv_bfloat16* pb = slice + ((lane % 8) + ((lane / 8) % 2) * 8) * LDB + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[RPW][4];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        if (warp + 8 * i < g.th) ldmatrix_x4(af[i], pa + 8 * i * g.bw * LDA + kk);
#pragma unroll
      for (int jp = 0; jp < NF / 2; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, pb + kk * LDB + jp * 16);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          if (warp + 8 * i >= g.th) continue;
          mma_bf16(a[i][2 * jp], af[i], bf[0], bf[1]);
          mma_bf16(a[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  // a[i][j] holds pixels lane/4 and lane/4 + 8 of row warp + 8 i, channels
  // n0 + 8 j + 2 (lane % 4) and the next
  __device__ void store(__nv_bfloat16* out, const Geom& g, int b, int y0, int x0, int n0) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + 8 * i, oy = y0 + r;
      if (r >= g.th || oy >= g.ho) continue;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int on = n0 + 8 * j + 2 * (lane % 4);
        if (on >= g.cout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ox = x0 + lane / 4 + 8 * h;
          if (ox >= g.wo) continue;
          *reinterpret_cast<uint32_t*>(out + ((size_t)(b * g.ho + oy) * g.wo + ox) * g.cout + on) =
              pack_bf16(a[i][j][2 * h], a[i][j][2 * h + 1]);
        }
      }
    }
  }
};

// f32: warp w owns channels n0 + 4 w .. + 3 (BN = 32); lane l owns pixels
// l + 32 i of the band's TH x 16 (row l / 16 + 2 i, column l % 16)
template <int BN, int RPW>
struct TileF32 {
  static_assert(BN == 32, "f32 tiles are 8 warps x 4 channels");
  static constexpr int PPT = 4 * RPW;
  float a[PPT][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PPT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
  }
  __device__ void add(const TileF32& o) {
#pragma unroll
    for (int i = 0; i < PPT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][e] += o.a[i][e];
  }
  __device__ void tap(const float* band, const float* slice, const Geom& g, int di, int dj) {
    constexpr int BK = Cfg<float>::BK, LDA = Cfg<float>::LDA, LDB = ldb<float, BN>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float* pa = band + ((lane / 16 + di) * g.bw + lane % 16 + dj) * LDA;
    for (int k = 0; k < BK; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(slice + k * LDB + 4 * warp);
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (lane / 16 + 2 * i >= g.th) continue;
        const float v = pa[2 * i * g.bw * LDA + k];
        a[i][0] = fmaf(v, wv.x, a[i][0]);
        a[i][1] = fmaf(v, wv.y, a[i][1]);
        a[i][2] = fmaf(v, wv.z, a[i][2]);
        a[i][3] = fmaf(v, wv.w, a[i][3]);
      }
    }
  }
  __device__ void store(float* out, const Geom& g, int b, int y0, int x0, int n0) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int on = n0 + 4 * warp, ox = x0 + lane % 16;
    if (on >= g.cout || ox >= g.wo) return;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int r = lane / 16 + 2 * i, oy = y0 + r;
      if (r >= g.th || oy >= g.ho) continue;
      *reinterpret_cast<float4*>(out + ((size_t)(b * g.ho + oy) * g.wo + ox) * g.cout + on) =
          make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
    }
  }
};

template <typename T, int BN, int RPW>
using Tile = typename std::conditional<std::is_same<T, float>::value, TileF32<BN, RPW>,
                                       TileBF16<BN, RPW>>::type;

// One stage is one (chunk, tap). dma: taps row-major (di outer); halo:
// column-major (dj outer), each dj's kh taps into the partial pd.
template <typename T, int BN, int RPW, bool HALO>
__global__ void __launch_bounds__(THREADS, 1)
conv_band(const T* __restrict__ xm, const T* __restrict__ xh, const T* __restrict__ w,
          T* __restrict__ out, Geom g) {
  constexpr int BK = Cfg<T>::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* bands = reinterpret_cast<T*>(smem + BAR_BYTES);
  T* ring = bands + 2 * band_elems<T>(g);
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * g.th;
  const int b = blockIdx.z / g.n_ntiles, n0 = (blockIdx.z % g.n_ntiles) * BN;
  const int taps = g.kh * g.kw, nchunks = (g.cin + BK - 1) / BK, total = nchunks * taps;

  auto tap_of = [&](int t, int& di, int& dj) {
    if (HALO) {
      dj = t / g.kh, di = t % g.kh;
    } else {
      di = t / g.kw, dj = t % g.kw;
    }
  };
  auto stage_band = [&](int c) {
    T* buf = bands + (c & 1) * band_elems<T>(g);
    if (HALO) {
      stage_rows(buf, xm, g, b, y0, x0, c * BK, 0, g.th);
      stage_rows(buf, xh, g, b, y0, x0, c * BK, g.th, g.bh);
    } else {
      stage_band_bulk(buf, xm, g, b, y0, x0, c * BK, &bars[c & 1]);
    }
  };
  auto load_stage = [&](int s) {
    int di, dj;
    tap_of(s % taps, di, dj);
    load_slice<T, BN>(ring + (s % NW) * slice_elems<T, BN>(), w, g, di * g.kw + dj, s / taps * BK,
                      n0);
  };

  if (!HALO) {
    if (threadIdx.x == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      mbar_fence_init();
    }
    __syncthreads();
  }
  stage_band(0);
  for (int s = 0; s < NW - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }
  Tile<T, BN, RPW> acc, pd;
  acc.zero();
  for (int s = 0; s < total; ++s) {
    const int c = s / taps, t = s % taps;
    if (HALO && t == 0)
      cp_async_wait_all();  // chunk c's band and the ring so far
    else
      cp_async_wait<NW - 2>();  // stage s's slice has landed
    __syncthreads();            // for every thread; stage s - 1 is consumed
    if (t == 0) {
      // the other band buffer was last read by chunk c - 1
      if (c + 1 < nchunks) stage_band(c + 1);
      if (!HALO) mbar_wait(&bars[c & 1], (c >> 1) & 1);
    }
    if (s + NW - 1 < total) load_stage(s + NW - 1);
    cp_async_commit();
    int di, dj;
    tap_of(t, di, dj);
    const T* band = bands + (c & 1) * band_elems<T>(g);
    const T* slice = ring + (s % NW) * slice_elems<T, BN>();
    if (HALO) {
      if (di == 0) pd.zero();
      pd.tap(band, slice, g, di, dj);
      if (di == g.kh - 1) acc.add(pd);
    } else {
      acc.tap(band, slice, g, di, dj);
    }
  }
  acc.store(out, g, b, y0, x0, n0);
}

template <typename T, int BN, bool HALO>
int launch(const void* xm, const void* xh, const void* w, void* out, Geom g, int n, cudaStream_t s) {
  g.n_ntiles = (g.cout + BN - 1) / BN;
  const size_t smem = smem_bytes<T, BN>(g);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((g.wo + TW - 1) / TW, (g.ho + g.th - 1) / g.th, n * g.n_ntiles);
  auto go = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kernel<<<grid, THREADS, smem, s>>>(static_cast<const T*>(xm), static_cast<const T*>(xh),
                                       static_cast<const T*>(w), static_cast<T*>(out), g);
  };
  switch ((g.th + 7) / 8) {
    case 1: go(conv_band<T, BN, 1, HALO>); break;
    case 2: go(conv_band<T, BN, 2, HALO>); break;
    case 3: go(conv_band<T, BN, 3, HALO>); break;
    default: go(conv_band<T, BN, 4, HALO>); break;
  }
  return (int)cudaGetLastError();
}

// the output-channel tile: bf16 64 for dma, 32 for halo (its partial doubles
// the accumulators); f32 32
template <bool HALO>
int run(const void* xm, const void* xh, const void* w, void* out, int dtype, int n, int hp, int wp,
        int cin, int kh, int kw, int cout, int th, void* stream) {
  if (n < 1 || kh < 1 || kw < 1 || hp < kh || wp < kw || th < 1 || th > MAX_TH || cin % 8 ||
      cout % 8)
    return (int)cudaErrorInvalidValue;
  const Geom g{hp, wp, cin, kh, kw, cout, hp - kh + 1, wp - kw + 1, th, th + kh - 1, TW + kw - 1, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16, HALO ? 32 : 64, HALO>(xm, xh, w, out, g, n, s);
  if (dtype == kF32) return launch<float, 32, HALO>(xm, xh, w, out, g, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace band
}  // namespace credit

using namespace credit;

// x (n, hp, wp, cin), w (kh, kw, cin, cout), out (n, hp-kh+1, wp-kw+1, cout),
// contiguous, 16-byte aligned, one dtype (kF32 or kBF16); cin % 8 == 0,
// cout % 8 == 0, 1 <= th <= 32, and a band that fits shared memory (th 32
// with a 16x16 kernel does not); cudaErrorInvalidValue otherwise.
extern "C" int credit_conv_band_dma(const void* x, const void* w, void* out, int dtype, int n,
                                    int hp, int wp, int cin, int kh, int kw, int cout, int th,
                                    void* stream) {
  return band::run<false>(x, nullptr, w, out, dtype, n, hp, wp, cin, kh, kw, cout, th, stream);
}

// The same, with the band's main rows read through xm and its halo rows
// through xh (both the same input).
extern "C" int credit_conv_band_halo(const void* xm, const void* xh, const void* w, void* out,
                                     int dtype, int n, int hp, int wp, int cin, int kh, int kw,
                                     int cout, int th, void* stream) {
  return band::run<true>(xm, xh, w, out, dtype, n, hp, wp, cin, kh, kw, cout, th, stream);
}
