// Monotonic alignment search (VITS MAS) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel music_generation_tpu/ops/monotonic_align.py
// (maximum_path_pallas, body _mas_kernel). Same recurrence as
// maximum_path_torch in ops/monotonic_align.py of this package, bit for bit:
//   value[y, x] = where(mask > 0, neg_cent, 0)
//   acc[y, x]   = value[y, x] + max(acc[y-1, x-1], acc[y-1, x])
// inside the band max(0, tx + y - ty) <= x < min(tx, y + 1); the x == y cell
// must come from the diagonal, x == 0 is open only at y == 0, MAX_NEG is
// -1e9 and cells outside the band keep value. A serial backtrace from
// (ty-1, tx-1) then steps left when index == y or
// acc[y-1, index] < acc[y-1, index-1] and gives the one-hot path, which is
// multiplied by the mask.
//
// What bounds it on the H100: not bytes (inputs and output are ~3 MB at the
// training shape B=8, Ty=480, Tx=64) but latency. Each item is a chain of Ty
// dependent rows followed by a chain of Ty dependent backtrace steps, and
// the card runs one such chain per item (8 of its 132 SMs at B=8). So the
// design shortens one link of each chain:
//   - one warp per batch item; lane l holds columns j * 32 + l (j < K, K a
//     power of two with 32 K >= Tx, so Tx <= 1024), the row in registers.
//     The left neighbour comes by warp shuffle: no barrier, no shared
//     memory on the row chain;
//   - the inputs of the next kAhead rows are loaded into registers while
//     the current rows run, without a branch, and combined only after them,
//     so no row waits on device memory;
//   - acc never leaves the registers: each row leaves one decision bit per
//     column, acc[y, x] < acc[y, x-1], packed by __ballot_sync into shared
//     memory ([Ty, K] words). The comparison is the one the backtrace would
//     make on acc, so the path is unchanged;
//   - the backtrace (lane 0) reads those bits and writes the path's column
//     of each row to shared memory; then the whole warp writes the path,
//     row by row. Nothing on either chain waits on device memory;
//   - one launch per call: the kernel takes the item's lengths from the
//     mask (the sums of its first column and first row, as the reference
//     does; exact for a 0/1 mask). The path's cells lie inside the item's
//     ty x tx box, where a 0/1 mask is 1, so the path is path * mask.

#include <cuda_runtime.h>

namespace {

constexpr float kMaxNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float value) {
  for (int o = 16; o > 0; o >>= 1) value += __shfl_xor_sync(kFull, value, o);
  return value;
}

// Raw inputs of row y at column x, clamped into the arrays so that the
// loads need no branch; a row past t_y is never used, a column past t_x is
// zeroed by value().
__device__ __forceinline__ void load_row(const float* v, const float* m,
                                         int y, int x, int t_y, int t_x,
                                         float& mv, float& vv) {
  const size_t o = static_cast<size_t>(min(y, t_y - 1)) * t_x +
                   min(x, t_x - 1);
  mv = m[o];
  vv = v[o];
}

__device__ __forceinline__ float value(float mv, float vv, int x, int t_x) {
  return x < t_x && mv > 0.f ? vv : 0.f;
}

template <int K>
__global__ void __launch_bounds__(32)
mas_kernel(const float* __restrict__ neg_cent, const float* __restrict__ mask,
           float* __restrict__ path, int t_y, int t_x) {
  constexpr int kAhead = K >= 32 ? 1 : (K >= 16 ? 2 : 32 / K);  // rows loaded ahead
  extern __shared__ unsigned smem[];
  unsigned* bits = smem;                                        // [t_y, K]
  int* col_of = reinterpret_cast<int*>(smem + static_cast<size_t>(t_y) * K);

  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * t_y * t_x;
  const float* v = neg_cent + base;
  const float* m = mask + base;
  float* p = path + base;

  float col_sum = 0.f, row_sum = 0.f;
  for (int y = lane; y < t_y; y += 32)
    col_sum += m[static_cast<size_t>(y) * t_x];
  for (int x = lane; x < t_x; x += 32) row_sum += m[x];
  const int ty = static_cast<int>(warp_sum(col_sum));
  const int tx = static_cast<int>(warp_sum(row_sum));
  for (int y = lane; y < t_y; y += 32) col_of[y] = -1;

  // acc[j]: row y-1 at column j * 32 + lane; left[j]: row y-1 at the column
  // before it.
  float acc[K], left[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = left[j] = kMaxNeg;
  float vals[kAhead][K];
#pragma unroll
  for (int a = 0; a < kAhead; ++a)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float mv, vv;
      load_row(v, m, a, j * 32 + lane, t_y, t_x, mv, vv);
      vals[a][j] = value(mv, vv, j * 32 + lane, t_x);
    }

  for (int y0 = 0; y0 < t_y; y0 += kAhead) {
    // The next rows' loads are issued here and first waited for at the end
    // of this group of rows, so they overlap its whole chain.
    float next_m[kAhead][K], next_v[kAhead][K];
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
#pragma unroll
      for (int j = 0; j < K; ++j)
        load_row(v, m, y0 + kAhead + a, j * 32 + lane, t_y, t_x,
                 next_m[a][j], next_v[a][j]);
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int y = y0 + a;
      if (y >= t_y) break;  // uniform across the warp
      const int lo = max(0, tx + y - ty);
      const int hi = min(tx, y + 1);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int x = j * 32 + lane;
        const float v_prev = x == 0 ? (y == 0 ? 0.f : kMaxNeg) : left[j];
        const float v_cur = x == y ? kMaxNeg : acc[j];
        acc[j] = (x >= lo && x < hi) ? vals[a][j] + fmaxf(v_prev, v_cur)
                                     : vals[a][j];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float up = __shfl_up_sync(kFull, acc[j], 1);
        const float wrap =
            __shfl_sync(kFull, acc[j > 0 ? j - 1 : 0], 31);
        left[j] = lane == 0 ? (j > 0 ? wrap : kMaxNeg) : up;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int x = j * 32 + lane;
        const unsigned word =
            __ballot_sync(kFull, x > 0 && x < t_x && acc[j] < left[j]);
        if (lane == 0) bits[y * K + j] = word;
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
#pragma unroll
      for (int j = 0; j < K; ++j)
        vals[a][j] = value(next_m[a][j], next_v[a][j], j * 32 + lane, t_x);
  }
  __syncwarp();

  if (lane == 0) {
    int index = tx - 1;  // tx == 0: no path
    for (int y = ty - 1; y >= 0 && index >= 0; --y) {
      col_of[y] = index;
      if (index != 0) {
        bool move = index == y;
        if (!move && y > 0)
          move = (bits[(y - 1) * K + (index >> 5)] >> (index & 31)) & 1u;
        if (move) --index;
      }
    }
  }
  __syncwarp();

#pragma unroll 4
  for (int y = 0; y < t_y; ++y) {
    const int c = col_of[y];
    float* row = p + static_cast<size_t>(y) * t_x;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int x = j * 32 + lane;
      if (x < t_x) row[x] = x == c ? 1.f : 0.f;
    }
  }
}

template <int K>
int launch(const float* neg_cent, const float* mask, float* path, int batch,
           int t_y, int t_x, cudaStream_t stream) {
  // The decision bits and the path's column of each row.
  const size_t smem = static_cast<size_t>(t_y) * (K + 1) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      mas_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mas_kernel<K><<<batch, 32, smem, stream>>>(neg_cent, mask, path, t_y, t_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mas_forward(const void* neg_cent, const void* mask,
                           void* path, int batch, int t_y, int t_x,
                           void* stream) {
  const float* nc = static_cast<const float*>(neg_cent);
  const float* m = static_cast<const float*>(mask);
  float* p = static_cast<float*>(path);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (t_x + 31) / 32;
  if (words <= 1) return launch<1>(nc, m, p, batch, t_y, t_x, s);
  if (words <= 2) return launch<2>(nc, m, p, batch, t_y, t_x, s);
  if (words <= 4) return launch<4>(nc, m, p, batch, t_y, t_x, s);
  if (words <= 8) return launch<8>(nc, m, p, batch, t_y, t_x, s);
  if (words <= 16) return launch<16>(nc, m, p, batch, t_y, t_x, s);
  if (words <= 32) return launch<32>(nc, m, p, batch, t_y, t_x, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
