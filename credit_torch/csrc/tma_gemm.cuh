// The warp-specialised TMA + wgmma mainloop of one 128 x BN output tile,
// shared by the VALID conv (conv_valid.cu, a tap is a shift of the A box),
// the feed-forward's two products (fused_ff.cu, plain row-major GEMMs) and
// the six of its backward (fused_ff_bwd.cu).
//
// A K step is 64 deep. Its stage holds A, 128 rows x 64 K values, then B,
// BN columns x 64 K values, each landed by the caller's TMA loads with
// 128-byte swizzle, K-major (K contiguous) or MN-major (M or N contiguous,
// read with wgmma's transpose bit): the conv and the forward read A K-major
// and B MN-major (row-major weights); the backward's products with a
// transposed weight read B K-major, its weight gradients, whose contraction
// runs over the rows, both MN-major (mma_stage). A ring of stages with
// full and empty mbarriers: one producer thread issues each step's loads; two
// consumer warpgroups, rows
// [64 cw, 64 cw + 64) of the tile each, run wgmma.mma_async with one group in
// flight and free a stage once its products are done. The f32 accumulators
// go to the caller's epilogue, which owns the rounding and the stores.
#pragma once

#include "common.cuh"

namespace credit {
namespace tma {

constexpr int KS = 64;        // K values per step (one 128-byte row)
constexpr int A_BYTES = 128 * KS * 2;
constexpr int BOX_BYTES = 64 * KS * 2;  // one 64-column block of B

// CTAS blocks resident on an SM. One block: a producer warpgroup that gives
// its registers to the two consumer warpgroups with setmaxnreg (40 / 232).
// Two blocks, so that one block's epilogue runs beside the other's
// products: each takes half the SM's shared memory (less the 1 KB the SM
// reserves a block) and of its registers; the producer is one warp after
// the consumers (ptxas compiles every warp to the launch bound's 112
// registers, which hold BN = 128's 64 accumulators). EXTRA bytes of shared
// memory after the ring are the epilogue's own (extra()).
template <int BN, int CTAS = 1, int EXTRA = 0>
struct Ring {
  static constexpr int THREADS = CTAS == 1 ? 384 : 288;
  static constexpr int STAGE = A_BYTES + BN * KS * 2;
  static constexpr int BUDGET = (CTAS == 1 ? kMaxSmem : kSmSmem / CTAS - 1024) - EXTRA;
  static constexpr int STAGES = (BUDGET - 2048) / STAGE < 8 ? (BUDGET - 2048) / STAGE : 8;
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t) + EXTRA;
  static_assert(CTAS == 1 || (CTAS == 2 && BN <= 128), "two blocks an SM: BN <= 128");
  // the 16-byte aligned EXTRA bytes, from the aligned base
  static __device__ __forceinline__ unsigned char* extra(unsigned char* smem) {
    return smem + STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
  }
};

// One block an SM: the producer is warpgroup 0; two: the warp after the
// consumers. Its first thread issues the loads.
template <int CTAS>
__device__ __forceinline__ bool is_producer() {
  return CTAS == 1 ? threadIdx.x < 128 : threadIdx.x >= 256;
}
template <int CTAS>
__device__ __forceinline__ int producer_thread() {
  return CTAS == 1 ? 0 : 256;
}

// A stage's products for consumer warpgroup cw (rows [64 cw, 64 cw + 64) of
// the tile), by operand major (wgmma's transpose bits). TA = 0: A K-major,
// 128 rows of 64 K values (128 bytes each); TA = 1: A MN-major, two boxes of
// 64 K rows x 64 M values, one per warpgroup. TB = 1: B MN-major, BN / 64
// boxes of 64 K rows x 64 N columns; TB = 0: B K-major, BN rows of 64 K
// values. Every form is 128-byte swizzled and fills A_BYTES and BN * 128
// bytes of the stage; a K-major k16 step is 32 bytes along the row, an
// MN-major one 16 rows (2048 bytes).
template <int BN, int TA, int TB>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2], uint32_t st, int cw) {
  const uint32_t a0 = st + cw * BOX_BYTES, b0 = st + A_BYTES;  // 64 K-major rows = one box
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk)
    Wgmma<BN>::template run<TA, TB>(
        acc, TA ? desc_sw128(a0 + kk * 2048, BOX_BYTES, 1024) : desc_sw128(a0 + kk * 32, 16, 1024),
        TB ? desc_sw128(b0 + kk * 2048, BOX_BYTES, 1024) : desc_sw128(b0 + kk * 32, 16, 1024));
}

// A consumer's place in the ring: the stage, the stage to free, the phase
struct RingPos {
  int s = 0, prev = -1;
  uint32_t ph = 0;
};

template <class R>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer thread: steps loads in order, each into the next stage once
// it is free; pos (s, ph) carries over between calls
template <class R, class Load>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        int steps, Load& load, RingPos& pos) {
  for (int it = 0; it < steps; ++it) {
    mbar_wait(&empty[pos.s], pos.ph ^ 1);
    mbar_expect_tx(&full[pos.s], R::STAGE);
    load(it, smem + pos.s * R::STAGE, &full[pos.s]);
    if (++pos.s == R::STAGES) {
      pos.s = 0;
      pos.ph ^= 1;
    }
  }
}

// `steps` K steps of one product into acc, from the ring at pos: wgmma with
// one group in flight, a stage freed once its products are done
template <class R, int BN, int TA, int TB>
__device__ __forceinline__ void consume(float (&acc)[BN / 2], unsigned char* smem,
                                        uint64_t* empty, uint64_t* full, int steps, int cw,
                                        RingPos& pos) {
  const int lane = threadIdx.x % 32;
  for (int it = 0; it < steps; ++it) {
    mbar_wait(&full[pos.s], pos.ph);
    wgmma_fence();
    mma_stage<BN, TA, TB>(acc, smem_u32(smem + pos.s * R::STAGE), cw);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done: free its stage
    if (pos.prev >= 0 && lane == 0) mbar_arrive(&empty[pos.prev]);
    pos.prev = pos.s;
    if (++pos.s == R::STAGES) {
      pos.s = 0;
      pos.ph ^= 1;
    }
  }
}

// The tile's mainloop over `steps` K steps. load(it, stage, bar), called for
// it = 0, 1, ... in order, issues step it's TMA loads (Ring::STAGE bytes in
// all: A at stage, B at stage + A_BYTES, laid out as mma_stage<BN, TA, TB>
// reads them) completing on bar; epilogue(acc, cw) gets consumer warpgroup
// cw's accumulators. Thread t of the warpgroup holds acc[4j + 2h + e] at
// tile row 64 cw + 16 (t / 32 % 4) + t % 32 / 4 + 8h, column 8j + 2 (t % 4)
// + e. smem_raw: Ring<BN, CTAS>::SMEM bytes of dynamic shared memory; every
// thread of the block calls this, in a kernel launched with
// __launch_bounds__(Ring<BN, CTAS>::THREADS, CTAS).
template <int BN, int CTAS = 1, int TA = 0, int TB = 1, class Load, class Epilogue>
__device__ __forceinline__ void gemm_tile(unsigned char* smem_raw, int steps, Load load,
                                          Epilogue epilogue) {
  using R = Ring<BN, CTAS>;
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  ring_init<R>(full, empty);
  if (is_producer<CTAS>()) {
    if constexpr (CTAS == 1) reg_dealloc<40>();
    RingPos pos;
    if (threadIdx.x == producer_thread<CTAS>()) produce<R>(smem, full, empty, steps, load, pos);
  } else {
    if constexpr (CTAS == 1) reg_alloc<232>();
    const int cw = threadIdx.x / 128 - (CTAS == 1);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    RingPos pos;
    consume<R, BN, TA, TB>(acc, smem, empty, full, steps, cw, pos);
    wgmma_wait<0>();
    fence_regs(acc);
    epilogue(acc, cw);
  }
}

// Two products of each 128 x BN tile through one ring, A K-major in both:
// steps1 K steps into acc1 (B of major TB1), then steps2 into acc2 (TB2).
// Persistent: the block walks the tiles t = blockIdx.x, blockIdx.x +
// gridDim.x, ... < tiles, and the producer loads the next tile's steps
// while the consumers run this one's epilogue. load(t, it, stage, bar) for
// it < steps1 + steps2; epilogue(t, acc1, acc2, cw) as gemm_tile's; R =
// Ring<BN, CTAS, EXTRA>, whose extra bytes the epilogue may use.
template <class R, int BN, int CTAS, int TB1, int TB2, class Load, class Epilogue>
__device__ __forceinline__ void gemm_tiles2(unsigned char* smem_raw, int tiles, int steps1,
                                            int steps2, Load load, Epilogue epilogue) {
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  ring_init<R>(full, empty);
  RingPos pos;
  if (is_producer<CTAS>()) {
    if constexpr (CTAS == 1) reg_dealloc<40>();
    if (threadIdx.x == producer_thread<CTAS>())
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        auto tile_load = [&](int it, unsigned char* st, uint64_t* bar) { load(t, it, st, bar); };
        produce<R>(smem, full, empty, steps1 + steps2, tile_load, pos);
      }
  } else {
    if constexpr (CTAS == 1) reg_alloc<232>();
    const int cw = threadIdx.x / 128 - (CTAS == 1), lane = threadIdx.x % 32;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      float acc1[BN / 2], acc2[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc1[i] = acc2[i] = 0.f;
      consume<R, BN, 0, TB1>(acc1, smem, empty, full, steps1, cw, pos);
      consume<R, BN, 0, TB2>(acc2, smem, empty, full, steps2, cw, pos);
      wgmma_wait<0>();
      fence_regs(acc1);
      fence_regs(acc2);
      if (pos.prev >= 0 && lane == 0) mbar_arrive(&empty[pos.prev]);  // the tile's last stage
      pos.prev = -1;
      epilogue(t, acc1, acc2, cw);
    }
  }
}

// A row-major bf16 (rows x cols) operand's tensor map, boxes of box_rows
// rows x 64 columns (K-major A and B, box_rows 128 or BN; MN-major, 64)
inline bool operand_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return bf16_map(map, base, 2, dims, strides, box);
}

}  // namespace tma
}  // namespace credit
