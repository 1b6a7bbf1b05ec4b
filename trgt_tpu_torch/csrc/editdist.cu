// Batched unit-cost Levenshtein distance (cluster genotyper's pairwise
// distance matrix).
//
// Replaces the TPU kernel trgt_tpu/kernels/editdist_pallas.py
// `_edit_kernel`. That kernel walks the rows of `a` with every column of
// `b` in a 128-lane vector, resolves the left chain with a Hillis-Steele
// min ladder, masks pad rows by token 0 and selects H[len_a, len_b] with a
// one-hot lane reduction: all of it the shape of a TPU vector unit. None
// of it is carried over.
//
// Design: the cluster genotyper asks for thousands of independent small
// problems (len_a * len_b <= 10000, so the shorter side is <= 100), which
// is the parallelism: ONE THREAD PER PAIR, 64 pairs per block. A thread
// keeps one DP column over the short sequence `a` (<= kMaxA rows) in
// shared memory, laid out [row][thread] so the 32 threads of a warp hit
// 32 different banks, and walks the long sequence `b` one character at a
// time. No barrier, no scan, no padding work: each thread runs exactly
// len_a * len_b cells with explicit lengths, and a zero-length side falls
// out of the recurrence (the column's first entry counts the characters
// of `b`). Distances are integers; the result is exact.
//
// What bounds it on an H100: operations, not bytes (a pair reads len_a +
// len_b bytes and writes 4). The serial chain of one pair (up to 10000
// dependent cells) sets the latency of a small batch; warps whose pairs
// differ in size idle on the shorter ones.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxA = 128;

__global__ void __launch_bounds__(kThreads)
edit_kernel(const uint8_t* __restrict__ a, int a_stride,
            const uint8_t* __restrict__ b, int b_stride,
            const int32_t* __restrict__ len_a,
            const int32_t* __restrict__ len_b, int32_t* __restrict__ out,
            int batch) {
  __shared__ int s_col[kMaxA + 1][kThreads];
  __shared__ uint8_t s_a[kMaxA][kThreads];

  const int tid = threadIdx.x;
  const int pair = blockIdx.x * kThreads + tid;
  if (pair >= batch) return;
  // lengths are clamped to the strides, so a bad length cannot leave the
  // arrays
  const int la = max(0, min(len_a[pair], min(a_stride, kMaxA)));
  const int lb = max(0, min(len_b[pair], b_stride));
  const uint8_t* pa = a + static_cast<size_t>(pair) * a_stride;
  const uint8_t* pb = b + static_cast<size_t>(pair) * b_stride;

  for (int i = 0; i < la; ++i) s_a[i][tid] = pa[i];
  for (int i = 0; i <= la; ++i) s_col[i][tid] = i;  // column j = 0

  for (int j = 0; j < lb; ++j) {
    const int c = pb[j];
    int diag = s_col[0][tid];
    int up = j + 1;  // H[0][j + 1]
    s_col[0][tid] = up;
    for (int i = 1; i <= la; ++i) {
      const int left = s_col[i][tid];
      const int sub = diag + (s_a[i - 1][tid] != c ? 1 : 0);
      const int v = min(sub, min(left, up) + 1);
      s_col[i][tid] = v;
      diag = left;
      up = v;
    }
  }
  out[pair] = s_col[la][tid];
}

}  // namespace

// a: (B, a_stride) bytes, the side with len_a <= 128; b: (B, b_stride)
// bytes; len_a, len_b: (B,) lengths (clamped to the strides); out: (B,)
// distances. Returns the launch's cudaGetLastError().
extern "C" int trgt_edit_distances(const uint8_t* a, int a_stride,
                                   const uint8_t* b, int b_stride,
                                   const int32_t* len_a,
                                   const int32_t* len_b, int32_t* out,
                                   int batch, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kThreads - 1) / kThreads;
  edit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, a_stride, b, b_stride, len_a, len_b, out, batch);
  return static_cast<int>(cudaGetLastError());
}
