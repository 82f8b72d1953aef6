// fastloader — multi-threaded .npy batch reader for the host data pipeline.
//
// Role: the native IO layer of the framework (the reference's equivalent
// throughput comes from torch DataLoader worker processes + pinned-memory
// copies, finetune/finetune_fully.py:113-116 and the CUDA-stream prefetcher
// era5_data/utils_data.py:20-57). Python-side np.load of a 270MB upper-air
// frame is single-threaded and GIL-bound when batching; this library reads
// and packs a whole batch of per-hour .npy files with a std::thread pool and
// releases the GIL for the entire operation (ctypes releases it around
// foreign calls).
//
// Supported .npy subset (exactly what pangu_tpu.data.NpyStore writes):
//   format 1.0/2.0, little-endian '<f4' or '<f8', C-order, no pickling.
//
// C ABI:
//   int64_t fl_read_npy(const char* path, float* out, int64_t capacity);
//       -> element count read, or -code on error.
//   int32_t fl_read_batch(const char** paths, int32_t n, float* out,
//                         int64_t per_elems, int32_t threads);
//       -> 0 on success; -(i+1) if file i failed. Slot i gets paths[i].

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int64_t ERR_OPEN = -1;
constexpr int64_t ERR_MAGIC = -2;
constexpr int64_t ERR_HEADER = -3;
constexpr int64_t ERR_DTYPE = -4;
constexpr int64_t ERR_ORDER = -5;
constexpr int64_t ERR_CAPACITY = -6;
constexpr int64_t ERR_TRUNCATED = -7;

struct NpyInfo {
  int64_t elems = 0;
  int itemsize = 0;  // 4 or 8
  int64_t data_offset = 0;
};

int64_t parse_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return ERR_MAGIC;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return ERR_MAGIC;
  const int major = magic[6];

  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return ERR_HEADER;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return ERR_HEADER;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
    info->data_offset = 12 + header_len;
  }

  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return ERR_HEADER;

  // dtype
  size_t dpos = header.find("'descr':");
  if (dpos == std::string::npos) return ERR_HEADER;
  if (header.find("'<f4'", dpos) != std::string::npos)
    info->itemsize = 4;
  else if (header.find("'<f8'", dpos) != std::string::npos)
    info->itemsize = 8;
  else
    return ERR_DTYPE;

  // C order only. Bounds-check before compare: on a truncated header,
  // compare(pos > size) throws std::out_of_range, and a C++ exception
  // escaping the extern "C" boundary into ctypes aborts the process
  // instead of returning the ERR_* code this API promises.
  size_t fpos = header.find("'fortran_order':");
  if (fpos == std::string::npos || fpos + 17 + 4 > header.size())
    return ERR_HEADER;
  if (header.compare(fpos + 17, 4, "True") == 0) return ERR_ORDER;

  // shape tuple product
  size_t spos = header.find("'shape':");
  if (spos == std::string::npos) return ERR_HEADER;
  size_t open = header.find('(', spos);
  size_t close = header.find(')', open);
  if (open == std::string::npos || close == std::string::npos) return ERR_HEADER;
  int64_t elems = 1;
  bool any = false;
  int64_t cur = -1;
  for (size_t i = open + 1; i <= close; ++i) {
    char ch = header[i];
    if (ch >= '0' && ch <= '9') {
      if (cur < 0) cur = 0;
      cur = cur * 10 + (ch - '0');
    } else if (cur >= 0) {
      elems *= cur;
      any = true;
      cur = -1;
    }
  }
  info->elems = any ? elems : 1;  // "()" scalar
  return 0;
}

int64_t read_npy_into(const char* path, float* out, int64_t capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return ERR_OPEN;
  NpyInfo info;
  int64_t rc = parse_header(f, &info);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  if (info.elems > capacity) {
    fclose(f);
    return ERR_CAPACITY;
  }

  if (info.itemsize == 4) {
    size_t got = fread(out, 4, size_t(info.elems), f);
    fclose(f);
    return got == size_t(info.elems) ? info.elems : ERR_TRUNCATED;
  }
  // f8 -> f4 conversion in 64k-element chunks
  std::vector<double> buf(65536);
  int64_t remaining = info.elems;
  float* dst = out;
  while (remaining > 0) {
    size_t take = size_t(remaining < int64_t(buf.size()) ? remaining
                                                         : int64_t(buf.size()));
    if (fread(buf.data(), 8, take, f) != take) {
      fclose(f);
      return ERR_TRUNCATED;
    }
    for (size_t i = 0; i < take; ++i) dst[i] = float(buf[i]);
    dst += take;
    remaining -= int64_t(take);
  }
  fclose(f);
  return info.elems;
}

}  // namespace

extern "C" {

int64_t fl_read_npy(const char* path, float* out, int64_t capacity) {
  return read_npy_into(path, out, capacity);
}

int32_t fl_read_batch(const char** paths, int32_t n, float* out,
                      int64_t per_elems, int32_t threads) {
  if (threads < 1) threads = 1;
  std::atomic<int32_t> next(0);
  std::atomic<int32_t> failed(0);

  auto worker = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int64_t rc = read_npy_into(paths[i], out + int64_t(i) * per_elems,
                                 per_elems);
      // a short file (rc < per_elems) would leave uninitialized garbage in
      // the slot tail — the numpy fallback raises on the same data, so the
      // native path must too (exact element count required)
      if (rc != per_elems) {
        int32_t expected = 0;
        failed.compare_exchange_strong(expected, -(i + 1));
      }
    }
  };

  int nt = threads < n ? threads : n;
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int i = 0; i < nt; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failed.load();
}

}  // extern "C"
