// fastload: threaded chunk read + decompress for the zarr-v2 data path
// (the port's copy of credit_tpu/native/fastload.cpp).
//
// The reference's input pipeline leans on torch DataLoader worker processes
// (reference: credit/datasets/load_dataset_and_dataloader.py) to hide
// decode latency behind training. Here the trainer keeps one process and
// one batch producer thread, and the parallelism is pushed down to this
// library: a C++ thread pool does file reads and zlib/gzip/zstd inflation
// concurrently, writing straight into caller-provided numpy buffers. Python
// stays out of the loop, and the GIL is released for the whole batch.
//
// zstd is compiled in only where <zstd.h> is found (CREDIT_FL_ZSTD, set by
// fastload.py after probing the compiler); without it capability bit 1 is
// clear and a zstd chunk reports status 4.
//
// C API (ctypes-friendly, no C++ types across the boundary):
//   fl_capabilities()                      -> bit0 zlib, bit1 zstd
//   fl_default_threads()                   -> the pool's size when the
//                                             caller passes n_threads <= 0
//   fl_decode_batch(...)                   -> parallel decompress of n
//                                             in-memory chunks
//   fl_read_decode_batch(...)              -> parallel open+read+decompress
//                                             of n files (local stores)
// Return value: 0 on success, else 1-based index of the first failing item
// (negated codes for setup errors). Per-item status lands in `status[]`:
//   0 ok, 1 open/read error, 2 decode error, 3 size mismatch,
//   4 unsupported codec, 5 missing (read path only; output left untouched).

#include <zlib.h>
#ifdef CREDIT_FL_ZSTD
#include <zstd.h>
#endif

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

enum Codec : int32_t { RAW = 0, ZLIB = 1, GZIP = 2, ZSTD = 3 };

// Decompress src[0..src_len) into dst[0..dst_len). Returns item status.
int decode_one(const uint8_t* src, size_t src_len, int32_t codec,
               uint8_t* dst, size_t dst_len) {
  switch (codec) {
    case RAW: {
      if (src_len != dst_len) return 3;
      std::memcpy(dst, src, dst_len);
      return 0;
    }
    case ZLIB:
    case GZIP: {
      z_stream zs;
      std::memset(&zs, 0, sizeof(zs));
      // 15+32: auto-detect zlib vs gzip headers — zarr "zlib" chunks carry
      // a zlib wrapper, "gzip" a gzip one; one path serves both.
      if (inflateInit2(&zs, 15 + 32) != Z_OK) return 2;
      zs.next_in = const_cast<Bytef*>(src);
      zs.avail_in = static_cast<uInt>(src_len);
      zs.next_out = dst;
      zs.avail_out = static_cast<uInt>(dst_len);
      int rc = inflate(&zs, Z_FINISH);
      size_t produced = dst_len - zs.avail_out;
      inflateEnd(&zs);
      if (rc != Z_STREAM_END) return 2;
      if (produced != dst_len) return 3;
      return 0;
    }
#ifdef CREDIT_FL_ZSTD
    case ZSTD: {
      size_t rc = ZSTD_decompress(dst, dst_len, src, src_len);
      if (ZSTD_isError(rc)) return 2;
      if (rc != dst_len) return 3;
      return 0;
    }
#endif
    default:
      return 4;
  }
}

// Read a whole file into buf (resized). Returns 0 ok, 5 missing, 1 error.
int read_file(const char* path, std::vector<uint8_t>& buf) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return 5;
  if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return 1; }
  long n = std::ftell(f);
  if (n < 0) { std::fclose(f); return 1; }
  std::rewind(f);
  buf.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(buf.data(), 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  if (got != static_cast<size_t>(n)) return 1;
  return 0;
}

// Every hardware thread (4 where the count is unknown).
int32_t default_threads() {
  int32_t hw = static_cast<int32_t>(std::thread::hardware_concurrency());
  return hw > 0 ? hw : 4;
}

// Run fn(i) for i in [0, n) on up to n_threads workers.
template <typename Fn>
void parallel_for(int64_t n, int32_t n_threads, Fn fn) {
  if (n <= 0) return;
  if (n_threads <= 0) n_threads = default_threads();
  if (n_threads > n) n_threads = static_cast<int32_t>(n);
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int32_t t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

int32_t first_failure(const int32_t* status, int64_t n, bool missing_ok) {
  for (int64_t i = 0; i < n; ++i) {
    if (status[i] != 0 && !(missing_ok && status[i] == 5))
      return static_cast<int32_t>(i + 1);
  }
  return 0;
}

}  // namespace

extern "C" {

int32_t fl_capabilities() {
#ifdef CREDIT_FL_ZSTD
  return 1 | 2;
#else
  return 1;
#endif
}

int32_t fl_default_threads() { return default_threads(); }

// n in-memory chunks -> n output buffers. All arrays have length n.
int32_t fl_decode_batch(int64_t n, const uint8_t** srcs,
                        const int64_t* src_lens, const int32_t* codecs,
                        uint8_t** dsts, const int64_t* dst_lens,
                        int32_t n_threads, int32_t* status) {
  parallel_for(n, n_threads, [&](int64_t i) {
    status[i] = decode_one(srcs[i], static_cast<size_t>(src_lens[i]),
                           codecs[i], dsts[i],
                           static_cast<size_t>(dst_lens[i]));
  });
  return first_failure(status, n, /*missing_ok=*/false);
}

// n files -> n output buffers; a missing file sets status 5 and leaves the
// destination untouched (zarr semantics: absent chunk == fill_value, the
// caller pre-fills). codec applies per item.
int32_t fl_read_decode_batch(int64_t n, const char** paths,
                             const int32_t* codecs, uint8_t** dsts,
                             const int64_t* dst_lens, int32_t n_threads,
                             int32_t* status) {
  parallel_for(n, n_threads, [&](int64_t i) {
    std::vector<uint8_t> raw;
    int rc = read_file(paths[i], raw);
    if (rc != 0) {
      status[i] = rc;
      return;
    }
    status[i] = decode_one(raw.data(), raw.size(), codecs[i], dsts[i],
                           static_cast<size_t>(dst_lens[i]));
  });
  return first_failure(status, n, /*missing_ok=*/true);
}

}  // extern "C"
