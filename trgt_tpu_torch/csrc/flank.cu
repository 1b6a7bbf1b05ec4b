// Batched ends-free affine flank alignment (span stage of `genotype`).
//
// Replaces the TPU kernels trgt_tpu/kernels/semiglobal_pallas.py
// `_flank_kernel` (one problem per row) and `_flank_kernel_seg` (several
// short same-pattern problems per 512-lane row). Both exist because a TPU
// row is a fixed-width vector; here every problem gets its own thread
// block and its own text length, so one kernel covers every width.
//
// Semantics (identical to the Pallas kernels and to the host twin
// trgt_tpu/kernels/align_host.py `align_ends_free_text`):
//   costs: match 0, mismatch `mism`, gap open `go_ge` (= gapo + gape),
//   extend `ge`; the pattern is global, the text has free ends
//   (row 0: H = 0, D = INF). Ties: diag > D > I, all with strict `<`;
//   D prefers open over extend; inside a row's insertion chain the later
//   gap-open column wins; at finalize the first minimum over j <= len.
//   Payloads carried forward along the optimal path: match count and the
//   first / last text column of any diagonal step.
//
// Design: one block per problem, one thread per column of a 256-column
// tile, looping over pattern rows and tiles. The H/D rows and their six
// payloads live in global scratch, 32 bytes per column (two int4), which
// the wrapper allocates; a thread only ever touches its own column there,
// so the loads and stores are coalesced. The insertion chain
// I[j] = min_{k<j} (N[k] + go_ge - ge*k - ge) + ge*j is an exclusive scan
// over (value, column) with the combine "left operand only if strictly
// smaller" (associative; it yields the rightmost argmin, the same payload
// the Pallas Hillis-Steele ladder selects): warp shuffles, a pass over
// the warp totals, and a carry across tiles. Scores are small integers,
// so int32 arithmetic is exact.
//
// What bounds it on an H100: each row reads and writes 32 bytes per
// column of scratch (L2-resident for window-sized texts) and pays five
// block barriers per 256-column tile; it is latency-bound, not
// bandwidth-bound, at the span stage's shapes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInf = 1 << 29;

__device__ __forceinline__ void take_left(int& v, int& k, int lv, int lk) {
  if (lv < v) {
    v = lv;
    k = lk;
  }
}

__global__ void __launch_bounds__(kThreads)
flank_kernel(const uint8_t* __restrict__ pattern, int pat_len,
             const uint8_t* __restrict__ text, int text_stride,
             const int32_t* __restrict__ lens,
             int4* __restrict__ scratch, int32_t* __restrict__ out,
             int mism, int go_ge, int ge) {
  __shared__ int s_h[kThreads], s_mh[kThreads], s_fsh[kThreads];
  __shared__ int s_mn[kThreads], s_fsn[kThreads], s_lsn[kThreads];
  __shared__ int s_iv[kThreads], s_ik[kThreads];
  __shared__ int s_wv[kWarps], s_wk[kWarps];
  // insertion-chain carry from earlier tiles of the row: value, column
  // and that column's payload
  __shared__ int c_v, c_k, c_m, c_fs, c_ls;
  // previous row's H and payload in the column left of the tile
  __shared__ int l_h, l_m, l_fs;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = lens[b] + 1;
  const uint8_t* pat = pattern + static_cast<size_t>(b) * pat_len;
  const uint8_t* txt = text + static_cast<size_t>(b) * text_stride;
  // column j: rows[2j] = (H, D, M_H, FS_H), rows[2j+1] = (LS_H, M_D,
  // FS_D, LS_D); a problem owns text_stride + 1 columns
  int4* rows = scratch + 2 * static_cast<size_t>(b) * (text_stride + 1);

  for (int j = tid; j < n; j += kThreads) {
    rows[2 * j] = make_int4(0, kInf, 0, -1);
    rows[2 * j + 1] = make_int4(-1, 0, -1, -1);
  }

  for (int i = 0; i < pat_len; ++i) {
    const int p = pat[i];
    if (p == 0) continue;  // pad rows leave the carry unchanged
    __syncthreads();
    if (tid == 0) {
      c_v = kInf;
      c_k = -1;
      c_m = 0;
      c_fs = -1;
      c_ls = -1;
    }
    for (int t0 = 0; t0 < n; t0 += kThreads) {
      const int j = t0 + tid;
      const bool valid = j < n;
      int4 a = make_int4(0, kInf, 0, -1);
      int4 c = make_int4(-1, 0, -1, -1);
      if (valid) {
        a = rows[2 * j];
        c = rows[2 * j + 1];
      }
      s_h[tid] = a.x;
      s_mh[tid] = a.z;
      s_fsh[tid] = a.w;
      __syncthreads();

      int hl, ml, fsl;
      if (tid > 0) {
        hl = s_h[tid - 1];
        ml = s_mh[tid - 1];
        fsl = s_fsh[tid - 1];
      } else {
        hl = l_h;
        ml = l_m;
        fsl = l_fs;
      }
      // D: open vs extend, open wins ties
      const int d_ext = a.y + ge;
      const int d_open = a.x + go_ge;
      const bool te = d_ext < d_open;
      const int d_row = te ? d_ext : d_open;
      const int m_d = te ? c.y : a.z;
      const int fs_d = te ? c.z : a.w;
      const int ls_d = te ? c.w : c.x;
      // diagonal: column j consumes text byte j-1
      int diag = kInf, m_dg = 0, fs_dg = -1, ls_dg = -1;
      if (valid && j >= 1) {
        const bool match = txt[j - 1] == p;
        diag = hl + (match ? 0 : mism);
        m_dg = ml + (match ? 1 : 0);
        fs_dg = fsl < 0 ? j - 1 : fsl;
        ls_dg = j - 1;
      }
      // H without insertions: diagonal wins ties over D
      const bool td = d_row < diag;
      const int nv = td ? d_row : diag;
      const int m_n = td ? m_d : m_dg;
      const int fs_n = td ? fs_d : fs_dg;
      const int ls_n = td ? ls_d : ls_dg;
      s_mn[tid] = m_n;
      s_fsn[tid] = fs_n;
      s_lsn[tid] = ls_n;

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

      // exclusive prefix: min over columns k < j
      int ev, ek;
      if (tid == 0) {
        ev = c_v;
        ek = c_k;
      } else {
        ev = s_iv[tid - 1];
        ek = s_ik[tid - 1];
      }
      if (valid) {
        int m_i, fs_i, ls_i;
        if (ek >= t0) {
          m_i = s_mn[ek - t0];
          fs_i = s_fsn[ek - t0];
          ls_i = s_lsn[ek - t0];
        } else {
          m_i = c_m;
          fs_i = c_fs;
          ls_i = c_ls;
        }
        // column 0 has no insertion (I = INF)
        const int iv = j >= 1 ? ev + ge * j : kInf;
        const bool ti = iv < nv;
        rows[2 * j] = make_int4(ti ? iv : nv, d_row, ti ? m_i : m_n,
                                ti ? fs_i : fs_n);
        rows[2 * j + 1] = make_int4(ti ? ls_i : ls_n, m_d, fs_d, ls_d);
      }
      __syncthreads();
      if (tid == kThreads - 1) {
        const int ck = s_ik[tid];
        if (ck >= t0) {
          c_m = s_mn[ck - t0];
          c_fs = s_fsn[ck - t0];
          c_ls = s_lsn[ck - t0];
        }
        c_v = s_iv[tid];
        c_k = ck;
        l_h = s_h[tid];
        l_m = s_mh[tid];
        l_fs = s_fsh[tid];
      }
    }
  }
  __syncthreads();

  // finalize: first minimum of H over columns 0..len
  int bv = INT_MAX, bj = INT_MAX;
  for (int j = tid; j < n; j += kThreads) {
    const int h = rows[2 * j].x;
    if (h < bv) {
      bv = h;
      bj = j;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int oj = __shfl_down_sync(0xffffffffu, bj, o);
    if (ov < bv || (ov == bv && oj < bj)) {
      bv = ov;
      bj = oj;
    }
  }
  if (lane == 0) {
    s_wv[warp] = bv;
    s_wk[warp] = bj;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (s_wv[w] < bv || (s_wv[w] == bv && s_wk[w] < bj)) {
        bv = s_wv[w];
        bj = s_wk[w];
      }
    }
    const int4 a = rows[2 * bj];
    const int4 c = rows[2 * bj + 1];
    out[4 * b + 0] = bv;
    out[4 * b + 1] = a.z;
    out[4 * b + 2] = a.w;
    out[4 * b + 3] = c.x;
  }
}

}  // namespace

// pattern: (B, pat_len) bytes, 0 = pad row; text: (B, text_stride) bytes;
// lens: (B,) text lengths (<= text_stride); scratch: B * (text_stride + 1)
// columns of 32 bytes; out: (B, 4) = score, matches, first, last.
// Returns the launch's cudaGetLastError().
extern "C" int trgt_flank_align(const uint8_t* pattern, int pat_len,
                                const uint8_t* text, int text_stride,
                                const int32_t* lens, void* scratch,
                                int32_t* out, int batch, int mism, int go_ge,
                                int ge, void* stream) {
  if (batch <= 0) return 0;
  flank_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pattern, pat_len, text, text_stride, lens,
      static_cast<int4*>(scratch), out, mism, go_ge, ge);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
