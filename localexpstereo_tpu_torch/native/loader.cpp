// Threaded .acrt cost-volume loader + preprocessing.
//
// The reference loads the headerless float32 [D, H, W] volume with a
// single-threaded fread into a preshaped cv::Mat (Utilities.hpp:140-201,
// main.cpp:353-358) and then runs fillOutOfView / convertVolumeL2R loops
// (main.cpp:146-199) on one core. At MiddV3 halfH scale each volume is
// ~1.2 GB, so load time is pure memory bandwidth: here the file is pread()
// in parallel d-slices, with the out-of-view fill applied in the same pass
// while the slice is still cache-hot. convert_l2r_fill likewise fuses the
// L->R recovery with the right-view fill.
//
// Exposed via ctypes (see native/__init__.py), which builds it at first use;
// the command lines and utils/prefetch.py read volumes through it.

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Out-of-view fill of one d-slice, margin 0 (main.cpp:146-176).
// mode 0 (left): vol[d][y][x<d] = vol[d][y][min(d, W-1)]
// mode 1 (right): vol[d][y][x>=W-d] = vol[d][y][max(W-d-1, 0)]
void fill_slice(float* s, int d, int h, int w, int mode) {
  if (d <= 0) return;
  if (mode == 0) {
    const int k = std::min(d, w);
    const int src = std::min(d, w - 1);
    for (int y = 0; y < h; ++y) {
      float* row = s + (int64_t)y * w;
      const float v = row[src];
      for (int x = 0; x < k; ++x) row[x] = v;
    }
  } else if (mode == 1) {
    const int k = std::min(d, w);
    const int src = std::max(w - k - 1, 0);
    for (int y = 0; y < h; ++y) {
      float* row = s + (int64_t)y * w;
      const float v = row[src];
      for (int x = w - k; x < w; ++x) row[x] = v;
    }
  }
}

bool pread_full(int fd, void* buf, int64_t count, int64_t offset) {
  char* p = static_cast<char*>(buf);
  while (count > 0) {
    ssize_t n = pread(fd, p, count, offset);
    if (n <= 0) return false;
    p += n;
    offset += n;
    count -= n;
  }
  return true;
}

}  // namespace

extern "C" {

// Reads a headerless float32 [d, h, w] volume and applies the out-of-view
// fill (mode 0 = left, 1 = right, -1 = none) in the same parallel pass.
// Returns 0 on success, -1 on open failure, -2 on short read.
int read_acrt_fill(const char* path, int d, int h, int w, int mode,
                   int threads, float* out) {
  const int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  const int64_t slice = (int64_t)h * w;
  const int nt = std::max(1, std::min(threads, d));
  std::vector<std::thread> pool;
  std::vector<int> status(nt, 0);
  for (int t = 0; t < nt; ++t) {
    pool.emplace_back([&, t]() {
      const int d0 = (int)((int64_t)d * t / nt);
      const int d1 = (int)((int64_t)d * (t + 1) / nt);
      for (int di = d0; di < d1; ++di) {
        float* dst = out + slice * di;
        if (!pread_full(fd, dst, slice * sizeof(float),
                        slice * sizeof(float) * di)) {
          status[t] = -2;
          return;
        }
        if (mode >= 0) fill_slice(dst, di, h, w, mode);
      }
    });
  }
  for (auto& th : pool) th.join();
  close(fd);
  for (int s : status)
    if (s != 0) return s;
  return 0;
}

// Right-view volume recovery volR[d][y][x] = volL[d][y][min(x + d, W - 1)]
// (main.cpp:178-199, margin 0) fused with the right-view out-of-view fill,
// parallel over d.
void convert_l2r_fill(const float* vol_l, int d, int h, int w, int threads,
                      float* out) {
  const int64_t slice = (int64_t)h * w;
  const int nt = std::max(1, std::min(threads, d));
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) {
    pool.emplace_back([&, t]() {
      const int d0 = (int)((int64_t)d * t / nt);
      const int d1 = (int)((int64_t)d * (t + 1) / nt);
      for (int di = d0; di < d1; ++di) {
        const float* src = vol_l + slice * di;
        float* dst = out + slice * di;
        const int span = std::max(w - di, 0);  // x where x + di < w
        for (int y = 0; y < h; ++y) {
          const float* srow = src + (int64_t)y * w;
          float* drow = dst + (int64_t)y * w;
          if (span > 0) memcpy(drow, srow + di, span * sizeof(float));
          const float edge = srow[w - 1];
          for (int x = span; x < w; ++x) drow[x] = edge;
        }
        fill_slice(dst, di, h, w, 1);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
