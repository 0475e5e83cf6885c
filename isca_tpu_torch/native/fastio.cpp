// Native runtime support for isca_tpu_torch (C++ counterpart of the
// reference's C components: postprocessing/mppnccombine.c,
// shared/mpp/nsclock.c, shared/memutils/memuse.c); the port's own copy of
// isca_tpu/native/fastio.cpp.
//
//  * combine_tiles: merge per-host binary diagnostic shards (contiguous f32
//    tiles decomposed along the latitude axis) into one global array buffer —
//    the mppnccombine equivalent for multi-host runs, but operating on raw
//    tiles so the Python NetCDF writer emits a single file.
//  * pack_f32: strided gather/pack of a hyperslab into a contiguous buffer
//    (used when staging device-gathered diagnostics for IO).
//  * rss_kb: resident set size (memuse.c equivalent).
//  * ns_clock: monotonic nanosecond clock (nsclock.c equivalent) backing the
//    mpp_clock-style named timers in isca_tpu_torch.utils.clocks.
//
// Exposed with plain C linkage for ctypes.

#include <chrono>
#include <cstdint>
#include <cstring>

#include <sys/resource.h>

extern "C" {

// Merge ntiles shards along axis 0 of a (rows_total, cols) f32 array.
// tiles[i] points at a contiguous (rows[i], cols) block whose global row
// offset is offsets[i]. Returns 0 on success, -1 on bounds error.
int combine_tiles(const float **tiles, const int64_t *rows,
                  const int64_t *offsets, int64_t ntiles, int64_t rows_total,
                  int64_t cols, float *out) {
  for (int64_t i = 0; i < ntiles; ++i) {
    if (offsets[i] < 0 || offsets[i] + rows[i] > rows_total) return -1;
    std::memcpy(out + offsets[i] * cols, tiles[i],
                static_cast<size_t>(rows[i]) * cols * sizeof(float));
  }
  return 0;
}

// Pack a strided 3-D hyperslab (n0,n1,n2 with strides s0,s1,s2 in elements)
// into a contiguous buffer.
void pack_f32(const float *src, int64_t n0, int64_t n1, int64_t n2, int64_t s0,
              int64_t s1, int64_t s2, float *dst) {
  int64_t idx = 0;
  for (int64_t i = 0; i < n0; ++i)
    for (int64_t j = 0; j < n1; ++j) {
      const float *row = src + i * s0 + j * s1;
      if (s2 == 1) {
        std::memcpy(dst + idx, row, static_cast<size_t>(n2) * sizeof(float));
        idx += n2;
      } else {
        for (int64_t k = 0; k < n2; ++k) dst[idx++] = row[k * s2];
      }
    }
}

// Resident set size in kB (memuse.c equivalent).
int64_t rss_kb() {
  struct rusage ru;
  if (getrusage(RUSAGE_SELF, &ru) != 0) return -1;
  return static_cast<int64_t>(ru.ru_maxrss);
}

// Monotonic nanosecond clock (nsclock.c equivalent).
int64_t ns_clock() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // extern "C"
