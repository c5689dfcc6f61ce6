// Monotonic alignment search — native CPU implementation (OpenMP).
//
// Copy of music_generation_tpu/runtime/native/monotonic_align.cc, the C++
// twin of the reference's Cython extension
// (VISinger/monotonic_align/core.pyx:1-42): a host oracle of MAS. It is no
// part of the training step, which runs the CUDA kernel
// (csrc/monotonic_align.cu) on a GPU and ops.maximum_path_torch on the CPU.
//
// Host code, built with g++ by runtime/native_loader.py.
// ABI: plain C, consumed via ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>

extern "C" {

static void maximum_path_each(int32_t* path, float* value, int t_y, int t_x,
                              int stride_y, float max_neg) {
  for (int y = 0; y < t_y; ++y) {
    int x_lo = std::max(0, t_x + y - t_y);
    int x_hi = std::min(t_x, y + 1);
    for (int x = x_lo; x < x_hi; ++x) {
      float v_cur = (x == y) ? max_neg : value[(y - 1) * stride_y + x];
      float v_prev;
      if (x == 0) {
        v_prev = (y == 0) ? 0.f : max_neg;
      } else {
        v_prev = value[(y - 1) * stride_y + x - 1];
      }
      value[y * stride_y + x] += std::max(v_prev, v_cur);
    }
  }
  int index = t_x - 1;
  for (int y = t_y - 1; y >= 0; --y) {
    path[y * stride_y + index] = 1;
    if (index != 0 && (index == y || value[(y - 1) * stride_y + index] <
                                         value[(y - 1) * stride_y + index - 1])) {
      --index;
    }
  }
}

// paths: [b, t_y, t_x] int32 (zero-initialized by caller)
// values: [b, t_y, t_x] float32 (mutated in place, like the reference)
void maximum_path_c(int32_t* paths, float* values, const int32_t* t_ys,
                    const int32_t* t_xs, int b, int t_y, int t_x) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < b; ++i) {
    maximum_path_each(paths + (int64_t)i * t_y * t_x,
                      values + (int64_t)i * t_y * t_x, t_ys[i], t_xs[i], t_x,
                      -1e9f);
  }
}

}  // extern "C"
