// Fast CSI window batch loader: the port's copy of the JAX package's
// native/csi_loader.cpp.
//
// The reference's data loading is its hottest host path: a Python loop of
// np.load + np.pad per sample (benchmark/wifi_csi/load_data.py:48-78).
// This loader parses the .npy headers directly, reads with pread into the
// right offset of a preallocated batch buffer (the left-pad falls out of
// zero-initialization), and fans out across a thread pool. Exposed to
// Python via ctypes (multi_modal_csi_tpu_torch/data/native_loader.py,
// which builds it with g++ at first use).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// Parse a .npy v1/v2 header; returns data offset, element count of the first
// axis (rows), and row stride in floats. Only little-endian float32 C-order
// arrays are supported (what the preprocessing pipeline writes).
bool parse_npy_header(int fd, int64_t* data_offset, int64_t* rows,
                      int64_t* row_floats) {
  unsigned char magic[10];
  if (pread(fd, magic, 10, 0) != 10) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  int64_t header_len;
  int64_t header_start;
  if (major == 1) {
    header_len = magic[8] | (magic[9] << 8);
    header_start = 10;
  } else {
    unsigned char ext[4];
    if (pread(fd, ext, 4, 8) != 4) return false;
    header_len = (int64_t)ext[0] | ((int64_t)ext[1] << 8) |
                 ((int64_t)ext[2] << 16) | ((int64_t)ext[3] << 24);
    header_start = 12;
  }
  std::string header(header_len, '\0');
  if (pread(fd, header.data(), header_len, header_start) != header_len)
    return false;
  if (header.find("'<f4'") == std::string::npos &&
      header.find("'|f4'") == std::string::npos)
    return false;
  if (header.find("'fortran_order': True") != std::string::npos) return false;
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t open = header.find('(', sp);
  size_t close = header.find(')', open);
  if (open == std::string::npos || close == std::string::npos) return false;
  std::string shape = header.substr(open + 1, close - open - 1);
  std::vector<int64_t> dims;
  int64_t cur = 0;
  bool has = false;
  for (char ch : shape) {
    if (ch >= '0' && ch <= '9') {
      cur = cur * 10 + (ch - '0');
      has = true;
    } else if (ch == ',') {
      if (has) dims.push_back(cur);
      cur = 0;
      has = false;
    }
  }
  if (has) dims.push_back(cur);
  if (dims.empty()) return false;
  *rows = dims[0];
  int64_t stride = 1;
  for (size_t i = 1; i < dims.size(); ++i) stride *= dims[i];
  *row_floats = stride;
  *data_offset = header_start + header_len;
  return true;
}

// Load one file into out[(target_len - t_used) * row_floats ...], where
// t_used = min(rows, target_len) and the LAST t_used rows of the source are
// kept — the reference's left-pad semantics (load_data.py:70-72).
bool load_one(const char* path, float* out, int64_t target_len,
              int64_t row_floats) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  int64_t data_offset, rows, file_row_floats;
  if (!parse_npy_header(fd, &data_offset, &rows, &file_row_floats) ||
      file_row_floats != row_floats) {
    close(fd);
    return false;
  }
  int64_t t_used = rows < target_len ? rows : target_len;
  int64_t src_row0 = rows - t_used;  // keep the tail when longer
  int64_t bytes = t_used * row_floats * (int64_t)sizeof(float);
  int64_t src_off = data_offset + src_row0 * row_floats * (int64_t)sizeof(float);
  float* dst = out + (target_len - t_used) * row_floats;
  int64_t done = 0;
  while (done < bytes) {
    ssize_t r = pread(fd, (char*)dst + done, bytes - done, src_off + done);
    if (r <= 0) {
      close(fd);
      return false;
    }
    done += r;
  }
  close(fd);
  return true;
}

}  // namespace

extern "C" {

// Load a batch of .npy CSI windows, left-padded to target_len.
// paths: n NUL-terminated strings; out: zero-initialized
// (n, target_len, row_floats) float32 buffer. Returns number of failures.
int csi_load_batch(const char** paths, int64_t n, int64_t target_len,
                   int64_t row_floats, float* out, int num_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      if (!load_one(paths[i], out + i * target_len * row_floats, target_len,
                    row_floats))
        failures.fetch_add(1);
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

// Probe a single file's shape: rows and row_floats. Returns 0 on success.
int csi_probe(const char* path, int64_t* rows, int64_t* row_floats) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return 1;
  int64_t off;
  bool ok = parse_npy_header(fd, &off, rows, row_floats);
  close(fd);
  return ok ? 0 : 2;
}

}  // extern "C"
