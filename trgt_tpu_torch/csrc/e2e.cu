// Batched global (end-to-end) affine alignment with traceback (consensus
// repair of the size, cluster and flank genotypers).
//
// Replaces the XLA device code trgt_tpu/kernels/e2e_device.py `_e2e_scan`
// (a `lax.scan` over pattern rows with a Hillis-Steele argmin ladder over
// the columns, the direction bits nibble-packed for the fetch over a
// remote link) and the host `_traceback` that followed it.
//
// Semantics (identical to `_e2e_scan`, and through it byte-identical
// CIGARs to the host twin `align_host.align_end_to_end`):
//   costs: match 0, mismatch `mism`, gap open `go_ge` (= gapo + gape),
//   extend `ge`; both sequences global. Row 0 is a leading insertion run:
//   H[0][0] = 0, H[0][j] = gapo + ge*j, D = INF.
//   Per cell, all comparisons strict:
//     take_ext = D_prev + ge < H_prev + go_ge        (open wins ties)
//     take_d   = D_row < diag                        (diagonal wins ties)
//     I[j] = min_{k<j}(N[k] + go_ge - ge*k - ge) + ge*j, N = H without
//            insertions; among equal minima the LATER k (the scan takes
//            its left operand only if strictly smaller)
//     take_i   = I < N
//   One byte per cell: choice (0 diag, 1 D, 2 I) | take_ext << 2 |
//   (k* != j-1) << 3, with k* = 0 in column 0 as in the reference.
//
// Design: one block per problem with its own lengths, one thread per
// column of a 256-column tile, looping over pattern rows and tiles. The
// previous row's H and D live in global scratch (8 bytes per column, a
// thread only touches its own column). The insertion chain is the same
// (value, column) scan with the rightmost-argmin combine as
// csrc/flank.cu: warp shuffles, a pass over the warp totals, a carry
// across tiles. Only rows <= len_p and columns <= len_t are computed and
// written; the wrapper hands in a zeroed bits array. Scores are small
// integers, so int32 arithmetic gives the bits of the reference's f32.
// After the last row, thread 0 of the block walks the traceback over the
// bits its block just wrote (L2-resident) and emits run-length CIGAR ops,
// last run first, so no direction bit ever crosses to the host.
//
// What bounds it on an H100: bytes by the roofline (one byte written per
// cell against a dozen integer operations), but in practice the latency
// of five block barriers per tile per row, and the single-thread
// traceback of len_p + len_t dependent loads at the end.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInf = 1 << 29;

enum Op : int { kEq = 0, kMis = 1, kDel = 2, kIns = 3 };

__device__ __forceinline__ void take_left(int& v, int& k, int lv, int lk) {
  if (lv < v) {
    v = lv;
    k = lk;
  }
}

__global__ void __launch_bounds__(kThreads)
e2e_kernel(const uint8_t* __restrict__ pattern, int pat_stride,
           const uint8_t* __restrict__ text, int text_stride,
           const int32_t* __restrict__ len_p,
           const int32_t* __restrict__ len_t, int2* __restrict__ scratch,
           uint8_t* __restrict__ bits, int32_t* __restrict__ score,
           int32_t* __restrict__ runs, int32_t* __restrict__ n_runs,
           int mism, int gapo, int ge) {
  __shared__ int s_h[kThreads];
  __shared__ int s_iv[kThreads], s_ik[kThreads];
  __shared__ int s_wv[kWarps], s_wk[kWarps];
  // insertion-chain carry from earlier tiles of the row
  __shared__ int c_v, c_k;
  // previous row's H in the column left of the tile
  __shared__ int l_h;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int go_ge = gapo + ge;
  const int lp = max(0, min(len_p[b], pat_stride));
  const int lt = max(0, min(len_t[b], text_stride));
  const int n = lt + 1;
  const int width = text_stride + 1;  // columns of one bits row
  const uint8_t* pat = pattern + static_cast<size_t>(b) * pat_stride;
  const uint8_t* txt = text + static_cast<size_t>(b) * text_stride;
  int2* rows = scratch + static_cast<size_t>(b) * width;
  uint8_t* cell =
      bits + static_cast<size_t>(b) * (pat_stride + 1) * width;

  // row 0: a leading insertion run
  for (int j = tid; j < n; j += kThreads) {
    rows[j] = make_int2(j == 0 ? 0 : gapo + ge * j, kInf);
    cell[j] = j == 0 ? 0 : (j == 1 ? 2 : (2 | 8));
  }

  for (int i = 1; i <= lp; ++i) {
    const int p = pat[i - 1];
    uint8_t* cell_row = cell + static_cast<size_t>(i) * width;
    __syncthreads();
    if (tid == 0) {
      c_v = kInf;
      c_k = -1;
    }
    for (int t0 = 0; t0 < n; t0 += kThreads) {
      const int j = t0 + tid;
      const bool valid = j < n;
      int2 hd = make_int2(0, kInf);
      if (valid) hd = rows[j];
      s_h[tid] = hd.x;
      __syncthreads();

      const int hl = tid > 0 ? s_h[tid - 1] : l_h;
      // D: open vs extend, open wins ties
      const int d_ext = hd.y + ge;
      const int d_open = hd.x + go_ge;
      const bool te = d_ext < d_open;
      const int d_row = te ? d_ext : d_open;
      // diagonal: column j consumes text byte j-1
      int diag = kInf;
      if (valid && j >= 1) diag = hl + (txt[j - 1] == p ? 0 : mism);
      // H without insertions: diagonal wins ties over D
      const bool td = d_row < diag;
      const int nv = td ? d_row : diag;

      // inclusive scan of (open base, column) over the tile
      int v = valid ? nv + go_ge - ge * j - ge : INT_MAX;
      int k = valid ? j : -1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int ov = __shfl_up_sync(0xffffffffu, v, o);
        const int ok = __shfl_up_sync(0xffffffffu, k, o);
        if (lane >= o) take_left(v, k, ov, ok);
      }
      if (lane == 31) {
        s_wv[warp] = v;
        s_wk[warp] = k;
      }
      __syncthreads();
      if (warp == 0) {
        int wv = lane < kWarps ? s_wv[lane] : INT_MAX;
        int wk = lane < kWarps ? s_wk[lane] : -1;
#pragma unroll
        for (int o = 1; o < kWarps; o <<= 1) {
          const int ov = __shfl_up_sync(0xffffffffu, wv, o);
          const int ok = __shfl_up_sync(0xffffffffu, wk, o);
          if (lane >= o) take_left(wv, wk, ov, ok);
        }
        if (lane < kWarps) {
          s_wv[lane] = wv;
          s_wk[lane] = wk;
        }
      }
      __syncthreads();
      if (warp > 0) take_left(v, k, s_wv[warp - 1], s_wk[warp - 1]);
      take_left(v, k, c_v, c_k);
      s_iv[tid] = v;
      s_ik[tid] = k;
      __syncthreads();

      if (valid) {
        // exclusive prefix: min over columns k < j; column 0 has no
        // insertion (I = INF) and k* = 0
        int iv = kInf, kstar = 0;
        if (j >= 1) {
          const int ev = tid == 0 ? c_v : s_iv[tid - 1];
          kstar = tid == 0 ? c_k : s_ik[tid - 1];
          iv = ev + ge * j;
        }
        const bool ti = iv < nv;
        rows[j] = make_int2(ti ? iv : nv, d_row);
        cell_row[j] = static_cast<uint8_t>(
            (ti ? 2 : (td ? 1 : 0)) | (te ? 4 : 0) |
            (kstar != j - 1 ? 8 : 0));
      }
      __syncthreads();
      if (tid == kThreads - 1) {
        c_v = s_iv[tid];
        c_k = s_ik[tid];
        l_h = s_h[tid];
      }
    }
  }
  __syncthreads();
  if (tid != 0) return;

  score[b] = rows[lt].x;
  // traceback as the reference's host `_traceback`: run-length ops, the
  // run that ends the alignment first
  int32_t* out = runs + static_cast<size_t>(b) * (pat_stride + text_stride);
  int count = 0, cur_op = -1, cur_len = 0;
  auto emit = [&](int op) {
    if (op == cur_op) {
      ++cur_len;
    } else {
      if (cur_len > 0) out[count++] = (cur_len << 2) | cur_op;
      cur_op = op;
      cur_len = 1;
    }
  };
  int i = lp, j = lt;
  while (i > 0 || j > 0) {
    int bt = cell[static_cast<size_t>(i) * width + j];
    int choice = bt & 3;
    if (i == 0) choice = 2;
    if (j == 0 && i > 0) choice = 1;
    if (choice == 0) {
      emit(pat[i - 1] == txt[j - 1] ? kEq : kMis);
      --i;
      --j;
    } else if (choice == 1) {
      emit(kDel);
      bool ext = bt & 4;
      --i;
      while (ext && i > 0) {
        bt = cell[static_cast<size_t>(i) * width + j];
        emit(kDel);
        ext = bt & 4;
        --i;
      }
    } else {
      emit(kIns);
      bool ext = bt & 8;
      --j;
      while (ext && j > 0) {
        bt = cell[static_cast<size_t>(i) * width + j];
        emit(kIns);
        ext = bt & 8;
        --j;
      }
    }
  }
  if (cur_len > 0) out[count++] = (cur_len << 2) | cur_op;
  n_runs[b] = count;
}

}  // namespace

// pattern: (B, pat_stride) bytes; text: (B, text_stride) bytes; len_p,
// len_t: (B,) lengths (clamped to the strides); scratch: B *
// (text_stride + 1) columns of 8 bytes; bits: (B, pat_stride + 1,
// text_stride + 1) bytes, zeroed by the caller; score: (B,); runs: (B,
// pat_stride + text_stride) ints, each length << 2 | op (0 '=', 1 'X',
// 2 'D', 3 'I'), the alignment's last run first; n_runs: (B,). Returns the
// launch's cudaGetLastError().
extern "C" int trgt_e2e_scan(const uint8_t* pattern, int pat_stride,
                             const uint8_t* text, int text_stride,
                             const int32_t* len_p, const int32_t* len_t,
                             void* scratch, uint8_t* bits, int32_t* score,
                             int32_t* runs, int32_t* n_runs, int batch,
                             int mism, int gapo, int ge, void* stream) {
  if (batch <= 0) return 0;
  e2e_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pattern, pat_stride, text, text_stride, len_p, len_t,
      static_cast<int2*>(scratch), bits, score, runs, n_runs, mism, gapo,
      ge);
  return static_cast<int>(cudaGetLastError());
}
