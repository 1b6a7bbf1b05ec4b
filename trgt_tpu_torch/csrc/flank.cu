// Batched ends-free affine flank alignment (span stage of `genotype`).
//
// Replaces the TPU kernels trgt_tpu/kernels/semiglobal_pallas.py
// `_flank_kernel` (one problem per row) and `_flank_kernel_seg` (several
// short same-pattern problems per 512-lane row). Both exist because a TPU
// row is a fixed-width vector; here every problem has its own text length
// and short problems share a block, one warp each, so the segmented
// packing has no counterpart of its own.
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
// What bounds it on an H100: the pattern rows are serial, and a row's
// insertion chain I[j] = min_{k<j} (N[k] + go_ge - ge*k - ge) + ge*j is a
// prefix scan along the text. The bytes are a few hundred per problem; the
// work is about fifty integer operations a cell. So the cost is what
// stands between two rows: barriers, memory round trips for the row
// state, and idle lanes.
//
// Design: a thread owns a strip of CW neighbouring columns and keeps
// their H, D and six payloads in registers for the whole problem; the
// text bytes of the strip are loaded once, the pattern 32 rows at a time
// (one byte per lane, handed round by shuffle). A row is two passes over
// the strip. Pass 1 takes the previous row's H to the left (inside the
// strip from a register, across strips by shuffle), updates D, the
// diagonal and N in place and folds the strip's chain elements. The scan
// element is (value, payload of its column) and the combine keeps the
// left operand only if it is strictly smaller: associative, and it yields
// the rightmost argmin in any scan order, the same payload the Pallas
// Hillis-Steele ladder selects. Pass 2 walks the strip with the exclusive
// prefix and settles H. Scores are small integers, so int32 is exact.
// Two classes, chosen from the padded text width:
//   warp class   up to 32 * CW columns (CW = 2, 4, 8, 16: widths up to
//                512): one warp per problem, four problems per block, the
//                prefix by warp shuffles, no shared memory and no barrier;
//   block class  wider texts: one block per problem (256 threads and CW =
//                4 for widths up to 1024, 512 threads and CW = 4 up to
//                2048, 512 threads and CW = 8 beyond: tiles of 4096
//                columns), two block barriers per row and tile (left
//                neighbour across warps; warp totals). Wide texts come a
//                few to a launch, so a problem's own latency counts, and
//                the widest block that keeps the strips in registers is
//                the fastest. A text wider than a tile is walked tile by
//                tile, all rows inside a tile, and each row's boundary
//                (the H to the left and the chain's prefix) waits in
//                shared memory for the next tile: no scratch in device
//                memory at any width.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpClassWarps = 4;
constexpr int kMaxBlockWarps = 16;
// ints a pattern row keeps in shared memory for the next tile
constexpr int kBoundaryInts = 7;

// An element of the insertion-chain scan: the open base of a column and
// that column's payload.
struct Chain {
  int v, m, fs, ls;
};

// The prefix to the left of everything: loses to every real column.
__device__ __forceinline__ Chain chain_start() {
  return Chain{kInf, 0, -1, -1};
}

// Neutral element of `combine` for real values (all below INT_MAX).
__device__ __forceinline__ Chain chain_none() {
  return Chain{INT_MAX, 0, -1, -1};
}

// Left operand only if strictly smaller: the rightmost argmin.
__device__ __forceinline__ Chain combine(const Chain& left,
                                         const Chain& right) {
  return left.v < right.v ? left : right;
}

__device__ __forceinline__ Chain shfl_up(const Chain& c, int o) {
  return Chain{__shfl_up_sync(kFull, c.v, o), __shfl_up_sync(kFull, c.m, o),
               __shfl_up_sync(kFull, c.fs, o),
               __shfl_up_sync(kFull, c.ls, o)};
}

// Inclusive scan of the lanes' strip totals.
__device__ __forceinline__ Chain warp_scan(Chain c, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Chain up = shfl_up(c, o);
    if (lane >= o) c = combine(up, c);
  }
  return c;
}

// The best end column so far: first minimum of H.
struct End {
  int v, j, m, fs, ls;
};

__device__ __forceinline__ void end_min(End& a, const End& b) {
  if (b.v < a.v || (b.v == a.v && b.j < a.j)) a = b;
}

__device__ __forceinline__ End warp_end(End a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const End b{__shfl_down_sync(kFull, a.v, o),
                __shfl_down_sync(kFull, a.j, o),
                __shfl_down_sync(kFull, a.m, o),
                __shfl_down_sync(kFull, a.fs, o),
                __shfl_down_sync(kFull, a.ls, o)};
    end_min(a, b);
  }
  return a;
}

// The pattern, 32 rows at a time: lane l holds row i0 + l, the next 32
// are loaded while these are used.
struct PatternRows {
  const uint8_t* pat;
  int pat_len;
  int lane;
  int cur, next;

  __device__ PatternRows(const uint8_t* pat_, int pat_len_, int lane_)
      : pat(pat_), pat_len(pat_len_), lane(lane_), cur(0) {
    next = lane < pat_len ? pat[lane] : 0;
  }
  __device__ __forceinline__ int row(int i) {
    if ((i & 31) == 0) {
      cur = next;
      next = i + 32 + lane < pat_len ? pat[i + 32 + lane] : 0;
    }
    return __shfl_sync(kFull, cur, i & 31);
  }
};

// CW neighbouring columns of one problem, in registers.
template <int CW>
struct Strip {
  int H[CW], D[CW], MH[CW], FSH[CW], LSH[CW], MD[CW], FSD[CW], LSD[CW];
  uint32_t tw[(CW + 3) / 4];  // text byte j-1 of column j, four to a word

  // row 0 of columns j0 .. j0+CW-1
  __device__ __forceinline__ void init(const uint8_t* txt, int text_stride,
                                       int j0) {
#pragma unroll
    for (int w = 0; w < (CW + 3) / 4; ++w) tw[w] = 0;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      H[c] = 0;
      D[c] = kInf;
      MH[c] = 0;
      FSH[c] = -1;
      LSH[c] = -1;
      MD[c] = 0;
      FSD[c] = -1;
      LSD[c] = -1;
      const int j = j0 + c;
      // 0 pads the text and never equals a pattern row's byte
      const uint32_t byte = j >= 1 && j - 1 < text_stride ? txt[j - 1] : 0;
      tw[c >> 2] |= byte << (8 * (c & 3));
    }
  }

  // D, diagonal and N (H without insertions) of pattern byte p, in place:
  // H and its payloads now hold N. (hl, ml, fsl) is the previous row's H
  // and payload in column j0-1. Returns the fold of the strip's chain
  // elements.
  __device__ __forceinline__ Chain pass1(int p, int j0, int hl, int ml,
                                         int fsl, int mism, int go_ge,
                                         int ge) {
    Chain tot = chain_none();
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int j = j0 + c;
      const int oh = H[c], om = MH[c], ofs = FSH[c], ols = LSH[c];
      // D: open vs extend, open wins ties
      const int d_ext = D[c] + ge;
      const int d_open = oh + go_ge;
      const bool te = d_ext < d_open;
      const int d_row = te ? d_ext : d_open;
      const int m_d = te ? MD[c] : om;
      const int fs_d = te ? FSD[c] : ofs;
      const int ls_d = te ? LSD[c] : ols;
      // diagonal: column j consumes text byte j-1
      int diag = kInf, m_dg = 0, fs_dg = -1, ls_dg = -1;
      if (j >= 1) {
        const bool match = ((tw[c >> 2] >> (8 * (c & 3))) & 0xFF) ==
                           static_cast<uint32_t>(p);
        diag = hl + (match ? 0 : mism);
        m_dg = ml + (match ? 1 : 0);
        fs_dg = fsl < 0 ? j - 1 : fsl;
        ls_dg = j - 1;
      }
      // N: diagonal wins ties over D
      const bool td = d_row < diag;
      H[c] = td ? d_row : diag;
      MH[c] = td ? m_d : m_dg;
      FSH[c] = td ? fs_d : fs_dg;
      LSH[c] = td ? ls_d : ls_dg;
      D[c] = d_row;
      MD[c] = m_d;
      FSD[c] = fs_d;
      LSD[c] = ls_d;
      tot = combine(tot, Chain{H[c] + go_ge - ge * j - ge, MH[c], FSH[c],
                               LSH[c]});
      hl = oh;
      ml = om;
      fsl = ofs;
    }
    return tot;
  }

  // H = min(N, I) with N winning ties; `run` is the chain's prefix over
  // all columns left of j0. Returns the prefix including the strip.
  __device__ __forceinline__ Chain pass2(Chain run, int j0, int go_ge,
                                         int ge) {
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int j = j0 + c;
      const Chain own{H[c] + go_ge - ge * j - ge, MH[c], FSH[c], LSH[c]};
      // column 0 has no insertion
      const int iv = j >= 1 ? run.v + ge * j : kInf;
      if (iv < H[c]) {
        H[c] = iv;
        MH[c] = run.m;
        FSH[c] = run.fs;
        LSH[c] = run.ls;
      }
      run = combine(run, own);
    }
    return run;
  }

  // first minimum of H over the strip's columns below n
  __device__ __forceinline__ void best_end(End& best, int j0, int n) const {
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int j = j0 + c;
      if (j < n && H[c] < best.v)
        best = End{H[c], j, MH[c], FSH[c], LSH[c]};
    }
  }
};

__device__ __forceinline__ void write_end(int32_t* out, int b,
                                          const End& best) {
  out[4 * b + 0] = best.v;
  out[4 * b + 1] = best.m;
  out[4 * b + 2] = best.fs;
  out[4 * b + 3] = best.ls;
}

// One warp per problem; the text has at most 32 * CW columns.
template <int CW>
__global__ void __launch_bounds__(32 * kWarpClassWarps)
flank_warp_kernel(const uint8_t* __restrict__ pattern, int pat_len,
                  const uint8_t* __restrict__ text, int text_stride,
                  const int32_t* __restrict__ lens,
                  int32_t* __restrict__ out, int batch, int mism, int go_ge,
                  int ge) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpClassWarps + (threadIdx.x >> 5);
  if (b >= batch) return;  // whole warps leave; no block barrier below
  const int n = lens[b] + 1;
  if (n > 32 * CW) __trap();  // the wrapper chose the class from the width
  const int j0 = lane * CW;
  Strip<CW> s;
  s.init(text + static_cast<size_t>(b) * text_stride, text_stride, j0);
  PatternRows rows(pattern + static_cast<size_t>(b) * pat_len, pat_len,
                   lane);
  for (int i = 0; i < pat_len; ++i) {
    const int p = rows.row(i);
    if (p == 0) continue;  // pad rows leave the carry unchanged
    const int hl = __shfl_up_sync(kFull, s.H[CW - 1], 1);
    const int ml = __shfl_up_sync(kFull, s.MH[CW - 1], 1);
    const int fsl = __shfl_up_sync(kFull, s.FSH[CW - 1], 1);
    const Chain tot = s.pass1(p, j0, hl, ml, fsl, mism, go_ge, ge);
    const Chain inc = warp_scan(tot, lane);
    Chain exc = shfl_up(inc, 1);
    if (lane == 0) exc = chain_none();
    s.pass2(combine(chain_start(), exc), j0, go_ge, ge);
  }
  End best{INT_MAX, INT_MAX, 0, -1, -1};
  s.best_end(best, j0, n);
  best = warp_end(best);
  if (lane == 0) write_end(out, b, best);
}

// One block of THREADS threads per problem; tiles of THREADS * CW columns.
// `boundary` (dynamic shared memory, 2 x kBoundaryInts x pat_len ints) is
// only touched when the text is wider than a tile.
template <int CW, int THREADS>
__global__ void __launch_bounds__(THREADS)
flank_block_kernel(const uint8_t* __restrict__ pattern, int pat_len,
                   const uint8_t* __restrict__ text, int text_stride,
                   const int32_t* __restrict__ lens,
                   int32_t* __restrict__ out, int mism, int go_ge, int ge) {
  extern __shared__ int boundary[];
  constexpr int kWarps = THREADS / 32;
  static_assert(kWarps <= kMaxBlockWarps, "block too wide");
  __shared__ int s_left[kWarps][3];
  __shared__ Chain s_tot[kWarps];
  __shared__ End s_end[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = lens[b] + 1;
  if (n > text_stride + 1) __trap();
  const uint8_t* txt = text + static_cast<size_t>(b) * text_stride;
  const uint8_t* pat = pattern + static_cast<size_t>(b) * pat_len;
  constexpr int kTile = THREADS * CW;

  End best{INT_MAX, INT_MAX, 0, -1, -1};
  int tile = 0;
  for (int t0 = 0; t0 < n; t0 += kTile, ++tile) {
    const int j0 = t0 + tid * CW;
    // a row's boundary: written by this tile's last thread for the next
    // tile, read from what the tile before wrote
    int* b_in = boundary + (tile & 1) * kBoundaryInts * pat_len;
    int* b_out = boundary + ((tile + 1) & 1) * kBoundaryInts * pat_len;
    const bool feeds_next = t0 + kTile < n && tid == THREADS - 1;
    Strip<CW> s;
    s.init(txt, text_stride, j0);
    PatternRows rows(pat, pat_len, lane);
    for (int i = 0; i < pat_len; ++i) {
      const int p = rows.row(i);
      if (p == 0) continue;  // pad rows leave the carry unchanged
      if (lane == 31) {
        s_left[warp][0] = s.H[CW - 1];
        s_left[warp][1] = s.MH[CW - 1];
        s_left[warp][2] = s.FSH[CW - 1];
      }
      if (feeds_next) {
        b_out[0 * pat_len + i] = s.H[CW - 1];
        b_out[1 * pat_len + i] = s.MH[CW - 1];
        b_out[2 * pat_len + i] = s.FSH[CW - 1];
      }
      int hl = __shfl_up_sync(kFull, s.H[CW - 1], 1);
      int ml = __shfl_up_sync(kFull, s.MH[CW - 1], 1);
      int fsl = __shfl_up_sync(kFull, s.FSH[CW - 1], 1);
      __syncthreads();
      if (lane == 0) {
        if (warp > 0) {
          hl = s_left[warp - 1][0];
          ml = s_left[warp - 1][1];
          fsl = s_left[warp - 1][2];
        } else if (tile > 0) {
          hl = b_in[0 * pat_len + i];
          ml = b_in[1 * pat_len + i];
          fsl = b_in[2 * pat_len + i];
        }
      }
      const Chain tot = s.pass1(p, j0, hl, ml, fsl, mism, go_ge, ge);
      const Chain inc = warp_scan(tot, lane);
      if (lane == 31) s_tot[warp] = inc;
      __syncthreads();
      Chain run = chain_start();
      if (tile > 0)
        run = Chain{b_in[3 * pat_len + i], b_in[4 * pat_len + i],
                    b_in[5 * pat_len + i], b_in[6 * pat_len + i]};
      for (int w = 0; w < warp; ++w) run = combine(run, s_tot[w]);
      Chain exc = shfl_up(inc, 1);
      if (lane == 0) exc = chain_none();
      run = s.pass2(combine(run, exc), j0, go_ge, ge);
      if (feeds_next) {
        b_out[3 * pat_len + i] = run.v;
        b_out[4 * pat_len + i] = run.m;
        b_out[5 * pat_len + i] = run.fs;
        b_out[6 * pat_len + i] = run.ls;
      }
    }
    s.best_end(best, j0, n);
    // keeps the tiles apart whatever rows were skipped
    __syncthreads();
  }

  best = warp_end(best);
  if (lane == 0) s_end[warp] = best;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) end_min(best, s_end[w]);
    write_end(out, b, best);
  }
}

template <int CW>
cudaError_t launch_warp(const uint8_t* pattern, int pat_len,
                        const uint8_t* text, int text_stride,
                        const int32_t* lens, int32_t* out, int batch,
                        int mism, int go_ge, int ge, cudaStream_t stream) {
  const int blocks = (batch + kWarpClassWarps - 1) / kWarpClassWarps;
  flank_warp_kernel<CW><<<blocks, 32 * kWarpClassWarps, 0, stream>>>(
      pattern, pat_len, text, text_stride, lens, out, batch, mism, go_ge,
      ge);
  return cudaGetLastError();
}

template <int CW, int THREADS>
cudaError_t launch_block(const uint8_t* pattern, int pat_len,
                         const uint8_t* text, int text_stride,
                         const int32_t* lens, int32_t* out, int batch,
                         int mism, int go_ge, int ge, cudaStream_t stream) {
  size_t smem = 0;
  if (text_stride + 1 > THREADS * CW)
    smem = 2 * kBoundaryInts * sizeof(int) * static_cast<size_t>(pat_len);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flank_block_kernel<CW, THREADS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  flank_block_kernel<CW, THREADS><<<batch, THREADS, smem, stream>>>(
      pattern, pat_len, text, text_stride, lens, out, mism, go_ge, ge);
  return cudaGetLastError();
}

}  // namespace

// pattern: (B, pat_len) bytes, 0 = pad row; text: (B, text_stride) bytes
// padded with 0; lens: (B,) text lengths, each below text_stride (a text
// of len bytes has len + 1 columns, which the padded width must hold);
// out: (B, 4) = score, matches, first, last. The class and the strip are
// chosen from text_stride (see the note at the top). Returns the
// launch's cudaGetLastError().
extern "C" int trgt_flank_align(const uint8_t* pattern, int pat_len,
                                const uint8_t* text, int text_stride,
                                const int32_t* lens, int32_t* out, int batch,
                                int mism, int go_ge, int ge, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (text_stride <= 64)
    e = launch_warp<2>(pattern, pat_len, text, text_stride, lens, out, batch,
                       mism, go_ge, ge, st);
  else if (text_stride <= 128)
    e = launch_warp<4>(pattern, pat_len, text, text_stride, lens, out, batch,
                       mism, go_ge, ge, st);
  else if (text_stride <= 256)
    e = launch_warp<8>(pattern, pat_len, text, text_stride, lens, out, batch,
                       mism, go_ge, ge, st);
  else if (text_stride <= 512)
    e = launch_warp<16>(pattern, pat_len, text, text_stride, lens, out,
                        batch, mism, go_ge, ge, st);
  else if (text_stride <= 1024)
    e = launch_block<4, 256>(pattern, pat_len, text, text_stride, lens, out,
                             batch, mism, go_ge, ge, st);
  else if (text_stride <= 2048)
    e = launch_block<4, 512>(pattern, pat_len, text, text_stride, lens, out,
                             batch, mism, go_ge, ge, st);
  else
    e = launch_block<8, 512>(pattern, pat_len, text, text_stride, lens, out,
                             batch, mism, go_ge, ge, st);
  return static_cast<int>(e);
}

extern "C" const char* trgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
