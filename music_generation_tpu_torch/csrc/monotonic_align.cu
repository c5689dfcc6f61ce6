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
// design shortens one link of each chain.
//
// Two variants; the wrapper (mas_plan in ops/monotonic_align.py) picks one
// from (Ty, Tx), and together they take every shape (no limit on Ty or Tx
// but the card's memory):
//   - mas_kernel, the warp variant (mas_forward): Tx <= 1024 and
//     4 * Ty * (K + 1) bytes of decision bits and path columns within the
//     227 KB of shared memory a block may have (Ty <= 1760 at K = 32, 19370
//     at K = 2). Described here.
//   - mas_wide_kernel, the wide variant (mas_forward_wide): every other
//     shape. Described where it is defined, below.
//
// The warp variant:
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


// The wide variant, for the shapes the warp variant refuses: decision bits
// past shared memory (long Ty) and more columns than one warp holds
// (Tx > 1024). Same recurrence, same decision bits, same backtrace, so the
// path is the warp variant's and the plain version's, bit for bit.
//   - a block of W warps per item, W = ceil(Tx / 32 K) with K the power of
//     two >= Tx / 256, so W <= 8 (K = 32, W = 8 past 8192 columns); warp w
//     holds columns w * 32 K + j * 32 + lane of a strip of W * 32 K
//     columns in registers, as the warp variant does. A row costs some K
//     serial steps per lane, so more warps of fewer columns each are
//     faster (PERF.md, section 6). The left neighbour of warp w's first column
//     is warp w-1's last column of the previous row: lane 31 of warp w-1
//     hands it over through a double-buffered shared slot, so each row
//     costs one barrier (none with W = 1);
//   - past W * 32 K = 8192 columns the row is cut into strips, run one after
//     the other: a strip's rows need only the previous strip's last column,
//     which its last lane writes to a global edge column (two of them, in
//     turn) and the next strip prefetches with its inputs;
//   - the decision bits ([Ty, ceil(Tx / 32)] words) and the path's column of
//     each row go to a global scratch the wrapper allocates; each row's
//     words leave in one coalesced store, off the row chain;
//   - the backtrace walks kStageRows rows at a time. Within them the column
//     moves left by at most one per row, so it needs only kStageWords words
//     of each row: the block stages those into shared memory, kBatch loads
//     in flight per thread, then thread 0 walks them. A few global round
//     trips per kStageRows rows instead of one per row;
//   - every thread writes the path, row by row, each warp a row at a time.
// Index arithmetic is size_t wherever a product of sizes is taken.
constexpr int kMaxWarps = 8;      // 8 warps x 1024 columns: one strip
constexpr int kStageRows = 256;   // backtrace rows per staged chunk
constexpr int kStageWords = kStageRows / 32 + 1;
constexpr int kBatch = 8;         // staged words loaded at once per thread
// shared words: hand-over slots [2][kMaxWarps], the warps' length sums
// [2][kMaxWarps], the backtrace's column, then the staged bits
constexpr int kWideHead = 4 * kMaxWarps + 1;
constexpr int kWideSmem = (kWideHead + kStageRows * kStageWords) * 4;

template <int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
mas_wide_kernel(const float* __restrict__ scores,
                const float* __restrict__ valid, float* __restrict__ out,
                int rows, int cols, unsigned* bits_all, int* col_all,
                float* edge_all) {
  constexpr int kAhead = K >= 32 ? 1 : (K >= 16 ? 2 : 32 / K);
  extern __shared__ unsigned wide_smem[];
  float* hand = reinterpret_cast<float*>(wide_smem);    // [2][kMaxWarps]
  float* sums = hand + 2 * kMaxWarps;                   // [2][kMaxWarps]
  int* at = reinterpret_cast<int*>(sums + 2 * kMaxWarps);
  unsigned* stage = wide_smem + kWideHead;    // [kStageRows][kStageWords]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int words = (cols + 31) >> 5;
  const int strip = n_warps * K * 32;
  const int n_strips = (cols + strip - 1) / strip;
  const size_t item = blockIdx.x;
  const float* v = scores + item * rows * cols;
  const float* m = valid + item * rows * cols;
  float* p = out + item * rows * cols;
  unsigned* bits = bits_all + item * rows * words;
  int* col_of = col_all + item * rows;
  float* edge = edge_all + item * 2 * rows;

  float col_sum = 0.f, row_sum = 0.f;
  for (int y = tid; y < rows; y += blockDim.x)
    col_sum += m[static_cast<size_t>(y) * cols];
  for (int x = tid; x < cols; x += blockDim.x) row_sum += m[x];
  col_sum = warp_sum(col_sum);
  row_sum = warp_sum(row_sum);
  if (lane == 0) {
    sums[warp] = col_sum;
    sums[kMaxWarps + warp] = row_sum;
  }
  __syncthreads();
  col_sum = row_sum = 0.f;
  for (int w = 0; w < n_warps; ++w) {
    col_sum += sums[w];
    row_sum += sums[kMaxWarps + w];
  }
  const int ty = static_cast<int>(col_sum);
  const int tx = static_cast<int>(row_sum);

  for (int s = 0; s < n_strips; ++s) {
    const int x0 = s * strip + warp * K * 32;  // this warp's first column
    const float* edge_in = edge + ((s + 1) & 1) * rows;  // strip s-1's last
    float* edge_out = edge + (s & 1) * rows;
    const bool reads_edge = s > 0 && tid == 0;
    const bool writes_edge = s + 1 < n_strips && warp == n_warps - 1 &&
                             lane == 31;
    // cur[j], before[j]: the previous row at column x0 + j * 32 + lane and
    // at the column before it
    float cur[K], before[K], in[kAhead][K], ein[kAhead];
#pragma unroll
    for (int j = 0; j < K; ++j) cur[j] = before[j] = kMaxNeg;
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float mv, vv;
        load_row(v, m, a, x0 + j * 32 + lane, rows, cols, mv, vv);
        in[a][j] = value(mv, vv, x0 + j * 32 + lane, cols);
      }
      ein[a] = reads_edge ? edge_in[min(a, rows - 1)] : kMaxNeg;
    }

    for (int r0 = 0; r0 < rows; r0 += kAhead) {
      float ahead_m[kAhead][K], ahead_v[kAhead][K], ahead_e[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          load_row(v, m, r0 + kAhead + a, x0 + j * 32 + lane, rows, cols,
                   ahead_m[a][j], ahead_v[a][j]);
        ahead_e[a] = reads_edge ? edge_in[min(r0 + kAhead + a, rows - 1)]
                                : kMaxNeg;
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int y = r0 + a;
        if (y >= rows) break;  // uniform across the block
        const int lo = max(0, tx + y - ty);
        const int hi = min(tx, y + 1);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int x = x0 + j * 32 + lane;
          const float v_prev = x == 0 ? (y == 0 ? 0.f : kMaxNeg) : before[j];
          const float v_cur = x == y ? kMaxNeg : cur[j];
          cur[j] = (x >= lo && x < hi) ? in[a][j] + fmaxf(v_prev, v_cur)
                                       : in[a][j];
        }
        float from_left = ein[a];  // the row's column x0 - 1
        if (n_warps > 1) {
          if (lane == 31) hand[(y & 1) * kMaxWarps + warp] = cur[K - 1];
          __syncthreads();
          if (warp > 0) from_left = hand[(y & 1) * kMaxWarps + warp - 1];
        }
        if (writes_edge) edge_out[y] = cur[K - 1];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float up = __shfl_up_sync(kFull, cur[j], 1);
          const float wrap = __shfl_sync(kFull, cur[j > 0 ? j - 1 : 0], 31);
          before[j] = lane == 0 ? (j > 0 ? wrap : from_left) : up;
        }
        unsigned mine = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int x = x0 + j * 32 + lane;
          const unsigned word =
              __ballot_sync(kFull, x > 0 && x < cols && cur[j] < before[j]);
          if (lane == j) mine = word;
        }
        const int word_at = (x0 >> 5) + lane;
        if (lane < K && word_at < words)
          bits[static_cast<size_t>(y) * words + word_at] = mine;
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          in[a][j] = value(ahead_m[a][j], ahead_v[a][j], x0 + j * 32 + lane,
                           cols);
        ein[a] = ahead_e[a];
      }
    }
    __syncthreads();  // the strip's bits and edge column are written
  }

  // Backtrace from (ty - 1, tx - 1), kStageRows rows at a time. Rows past
  // ty, and every row of an item with tx == 0, get no column.
  int index = tx - 1;
  for (int hi_row = tx > 0 ? ty - 1 : -1; hi_row >= 0;
       hi_row -= kStageRows) {
    const int lo_row = max(0, hi_row - kStageRows + 1);
    // rows lo_row..hi_row read the bits of rows first..hi_row-1 at columns
    // index - (kStageRows - 1) .. index
    const int first = max(0, lo_row - 1);
    const int w0 = max(0, index - (kStageRows - 1)) >> 5;
    const int n = (hi_row - first) * kStageWords;
    // kBatch loads in flight per thread before the first store waits
    for (int i0 = tid; i0 < n; i0 += kBatch * blockDim.x) {
      unsigned got[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        const int r = i / kStageWords, w = w0 + i % kStageWords;
        got[u] = i < n && w < words
                     ? bits[static_cast<size_t>(first + r) * words + w]
                     : 0u;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u * blockDim.x < n) stage[i0 + u * blockDim.x] = got[u];
    }
    __syncthreads();
    if (tid == 0) {
      for (int y = hi_row; y >= lo_row; --y) {
        col_of[y] = index;
        if (index != 0) {
          bool move = index == y;
          if (!move && y > 0)
            move = (stage[(y - 1 - first) * kStageWords + (index >> 5) - w0] >>
                    (index & 31)) & 1u;
          if (move) --index;
        }
      }
      *at = index;
    }
    __syncthreads();
    index = *at;
  }

  // The path: warp w writes rows w * 32 .. w * 32 + 31, then every
  // n_warps * 32-th group after them; lane l fetches row l's column.
  for (int g = warp * 32; g < rows; g += n_warps * 32) {
    const int y = g + lane;
    const int c_lane = y < rows && y < ty && tx > 0 ? col_of[y] : -1;
    const int n = min(32, rows - g);
    for (int r = 0; r < n; ++r) {
      const int c = __shfl_sync(kFull, c_lane, r);
      float* row = p + static_cast<size_t>(g + r) * cols;
      for (int x = lane; x < cols; x += 32) row[x] = x == c ? 1.f : 0.f;
    }
  }
}

template <int K>
int start_wide(const float* scores, const float* valid, float* out,
               int batch, int rows, int cols, int n_warps, unsigned* bits,
               int* col_of, float* edge, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mas_wide_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWideSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mas_wide_kernel<K><<<batch, n_warps * 32, kWideSmem, stream>>>(
      scores, valid, out, rows, cols, bits, col_of, edge);
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


// The wide variant: k is the columns per lane (a power of two <= 32) and
// n_warps the warps per item (1..8), as mas_plan picks them. scratch holds, in this order, the decision bits
// [batch, t_y, ceil(t_x / 32)] (uint32), the path's columns [batch, t_y]
// (int32) and the edge columns [batch, 2, t_y] (float32, used when a row
// has more than n_warps * 32 * k columns).
extern "C" int mas_forward_wide(const void* neg_cent, const void* mask,
                                void* path, int batch, int t_y, int t_x,
                                int k, int n_warps, void* scratch,
                                void* stream) {
  const float* nc = static_cast<const float*>(neg_cent);
  const float* m = static_cast<const float*>(mask);
  float* p = static_cast<float*>(path);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_warps < 1 || n_warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t cells = static_cast<size_t>(batch) * t_y;
  unsigned* bits = static_cast<unsigned*>(scratch);
  int* col_of = reinterpret_cast<int*>(bits + cells * ((t_x + 31) / 32));
  float* edge = reinterpret_cast<float*>(col_of + cells);
  switch (k) {
    case 1: return start_wide<1>(nc, m, p, batch, t_y, t_x, n_warps, bits,
                                 col_of, edge, st);
    case 2: return start_wide<2>(nc, m, p, batch, t_y, t_x, n_warps, bits,
                                 col_of, edge, st);
    case 4: return start_wide<4>(nc, m, p, batch, t_y, t_x, n_warps, bits,
                                 col_of, edge, st);
    case 8: return start_wide<8>(nc, m, p, batch, t_y, t_x, n_warps, bits,
                                 col_of, edge, st);
    case 16: return start_wide<16>(nc, m, p, batch, t_y, t_x, n_warps, bits,
                                   col_of, edge, st);
    case 32: return start_wide<32>(nc, m, p, batch, t_y, t_x, n_warps, bits,
                                   col_of, edge, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
