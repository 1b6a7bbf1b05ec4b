// Batched unit-cost Levenshtein distance (cluster genotyper's pairwise
// distance matrix).
//
// Replaces the TPU kernel trgt_tpu/kernels/editdist_pallas.py
// `_edit_kernel`. That kernel walks the rows of `a` with every column of
// `b` in a 128-lane vector, resolves the left chain with a Hillis-Steele
// min ladder, masks pad rows by token 0 and selects H[len_a, len_b] with a
// one-hot lane reduction: all of it the shape of a TPU vector unit.
//
// What bounds it on an H100: operations, not bytes (a pair reads len_a +
// len_b bytes and writes 4), and of a small batch the longest chain of
// dependent steps of one pair. The cluster genotyper asks for pairs with
// len_a * len_b <= 10000 with the shorter side on `a`, so len_a <= 100
// while len_b reaches 10000: the chain to keep short runs along `b`.
//
// Design: ONE WARP PER PAIR, four pairs a block, no block barrier. The
// warp walks the rows of the short side `a`; a lane owns a strip of kCw
// neighbouring columns of `b` and keeps their H in registers. A row is
//   pre[j] = min(H_old[j-1] + (a_i != b_j), H_old[j] + 1)
//   H[j]   = min(pre[j], H[j-1] + 1)
// and the second line, the chain along the row, is what a lane cannot do
// alone. A strip acts on the value entering from its left as
// x -> min(x + kCw, m), m its last column's value with nothing entering;
// these maps compose, so the value entering lane l is
// kCw * (l-1) + min over l' < l of (m_l' - kCw * l'): one min-scan of a
// single int by warp shuffles. Pass 1 computes pre, the strip's own chain
// and m; pass 2 folds the entering value in. A `b` wider than 32 * kCw
// columns is walked tile by tile, all rows inside a tile, and the tile's
// last column of every row waits in shared memory for the next tile. So a
// pair costs (len_b / 128 + 1) * len_a steps of a few shuffles, at most a
// few hundred, instead of len_a * len_b dependent cells. Explicit
// lengths; a zero-length side falls out (no rows: H stays row 0; no
// columns but column 0: H[i][0] = i). Distances are integers; the result
// is exact.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kCw = 4;
constexpr int kTile = 32 * kCw;
constexpr int kMaxA = 128;
constexpr int kInf = 1 << 29;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarps)
edit_kernel(const uint8_t* __restrict__ a, int a_stride,
            const uint8_t* __restrict__ b, int b_stride,
            const int32_t* __restrict__ len_a,
            const int32_t* __restrict__ len_b, int32_t* __restrict__ out,
            int batch) {
  // the last column of every row of the tile before this one, and of this
  // one for the next
  __shared__ int s_edge[kWarps][2][kMaxA + 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= batch) return;  // whole warps leave; no block barrier below
  // lengths are clamped to the strides, so a bad length cannot leave the
  // arrays
  const int la = max(0, min(len_a[pair], min(a_stride, kMaxA)));
  const int lb = max(0, min(len_b[pair], b_stride));
  const uint8_t* pa = a + static_cast<size_t>(pair) * a_stride;
  const uint8_t* pb = b + static_cast<size_t>(pair) * b_stride;

  // `a`, four bytes a lane
  uint32_t a_word = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * lane + q;
    if (i < la) a_word |= static_cast<uint32_t>(pa[i]) << (8 * q);
  }

  int result = 0;
  int tile = 0;
  for (int t0 = 0; t0 <= lb; t0 += kTile, ++tile) {
    const int j0 = t0 + lane * kCw;
    const int* edge_in = s_edge[warp][tile & 1];
    int* edge_out = s_edge[warp][(tile + 1) & 1];
    const bool feeds_next = t0 + kTile <= lb && lane == 31;
    int H[kCw];
    uint32_t bw = 0;  // byte j-1 of `b` for column j
#pragma unroll
    for (int c = 0; c < kCw; ++c) {
      const int j = j0 + c;
      H[c] = j;  // row 0
      if (j >= 1 && j <= lb) bw |= static_cast<uint32_t>(pb[j - 1]) << (8 * c);
    }
    if (feeds_next) edge_out[0] = H[kCw - 1];

    for (int i = 1; i <= la; ++i) {
      const uint32_t word = __shfl_sync(kFull, a_word, (i - 1) >> 2);
      const uint32_t ai = (word >> (8 * ((i - 1) & 3))) & 0xFF;
      // H_old to the left of the strip, and the new H entering the tile
      int hl = __shfl_up_sync(kFull, H[kCw - 1], 1);
      int enter = kInf;
      if (t0 > 0) {
        if (lane == 0) hl = edge_in[i - 1];
        enter = edge_in[i];
      }
      // pass 1: pre and the strip's own chain
      int run = kInf;
#pragma unroll
      for (int c = 0; c < kCw; ++c) {
        const int j = j0 + c;
        const int oh = H[c];
        int pre = oh + 1;
        if (j >= 1) pre = min(pre, hl + (((bw >> (8 * c)) & 0xFF) != ai));
        run = min(pre, run + 1);
        H[c] = run;
        hl = oh;
      }
      // the value entering each strip
      int scan = run - kCw * lane;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFull, scan, o);
        if (lane >= o) scan = min(scan, up);
      }
      int before = __shfl_up_sync(kFull, scan, 1);
      if (lane == 0) before = kInf;
      const int cin = min(before + kCw * (lane - 1), enter + kCw * lane);
      // pass 2
#pragma unroll
      for (int c = 0; c < kCw; ++c) H[c] = min(H[c], cin + c + 1);
      if (feeds_next) edge_out[i] = H[kCw - 1];
    }
    // the next tile reads what lane 31 wrote
    __syncwarp();
    if (t0 + kTile > lb) {
      int v = H[0];
#pragma unroll
      for (int c = 1; c < kCw; ++c)
        if (c == lb % kCw) v = H[c];
      result = __shfl_sync(kFull, v, (lb - t0) / kCw);
    }
  }
  if (lane == 0) out[pair] = result;
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
  const int blocks = (batch + kWarps - 1) / kWarps;
  edit_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      a, a_stride, b, b_stride, len_a, len_b, out, batch);
  return static_cast<int>(cudaGetLastError());
}
