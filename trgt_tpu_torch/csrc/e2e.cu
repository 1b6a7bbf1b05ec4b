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
//     I[j]     = min(I[j-1] + ge, N[j-1] + go_ge), N = H without
//                insertions, I[0] = INF
//     i_ext    = I[j-1] + ge < N[j-1] + go_ge        (open wins ties)
//     take_i   = I < N
//   One byte per cell: choice (0 diag, 1 D, 2 I) | take_ext << 2 |
//   i_ext << 3, with bit 3 set in column 0 of rows >= 1. `_e2e_scan`
//   writes bit 3 as (k* != j-1), k* the rightmost argmin of the insertion
//   chain's open bases and 0 in column 0: the same bit, because among
//   equal minima the later column wins, so k* = j-1 exactly when opening
//   at j-1 is no worse than extending.
//
// The bits are local recurrences, so any evaluation order gives them. Two
// classes, each with the order that leaves the shortest chain of
// dependent steps on this card, and each with its own layout of the bits,
// chosen so that what a warp writes in one step lies side by side
// (scattered one-strip stores to 32 different rows took more than half of
// the first version's time):
//
//   full matrix  one warp per problem, four problems a block, no block
//     barrier. A lane owns a strip of CW neighbouring columns (CW = 2, 4,
//     8, 16 from the padded text width) and keeps their H and D in
//     registers; the rows run down the lanes as a wavefront, lane l on row
//     i while lane l+1 is on row i-1, and a lane hands its right
//     neighbour two values by shuffle: the previous row's H of its last
//     column and the I entering the next column, packed with its extend
//     flag. Each lane loads its own pattern byte a step ahead. lp + 31
//     steps of CW cells for a tile of 32*CW columns, no scan, no scratch
//     in device memory. A text wider than a tile is walked tile by tile
//     and each row's boundary (two ints) waits in shared memory. Bits: by
//     tile, step and lane, so a step is one store of 32*CW bytes a warp;
//     row 0 is a formula and is not stored.
//
//   band  cells with j - i in [min(0,T-P) - W, max(0,T-P) + W] only, W per
//     problem, one byte per band cell, k = j - i - lo its band lane; cells
//     outside the band read as INF (a D from above the band and an I from
//     left of it do not exist). In band coordinates a cell needs (i-1,k),
//     (i-1,k+1) and (i,k-1), which no skew of lanes over rows satisfies
//     without idling half the lanes; but all three lie on the two
//     anti-diagonals before the cell's own (i + j = a), so the kernel
//     walks anti-diagonals, every cell of one in parallel, P + T steps. A
//     cell leaves three ints: its H (read two steps later by the cell
//     diagonally below), what the cell below takes as D and what the cell
//     to the right takes as I, each packed with its extend flag. Bands up
//     to 128 lanes: a warp per problem, the three ints of 4 band lanes in
//     a lane's registers, one shuffle a step, no barrier, and a loop body
//     without the matrix's edges for the steps that have none. Up to 4096
//     lanes: the same with 2 to 16 warps a problem (4 or 8 band lanes a
//     thread), the one value that crosses between two warps through
//     shared memory and a block barrier a step. Wider still: a block per
//     problem, the ints in shared memory. Bits: by anti-diagonal, every
//     second band lane (the others hold no cell on it), so a step's bytes
//     lie side by side. The flag `certified` is set when the band covers
//     the whole matrix or the score is strictly below gapo + gapo + ge *
//     (2W + 2 + |T-P|): no path that leaves the band can then be as cheap,
//     and score, bits on the optimal path and CIGAR are the full matrix's
//     (proof in kernels/align_banded.py).
//
// Traceback, both classes: on the card, by one warp over the bits its
// block just wrote (they are in L2). Lane l reads the cell l steps down
// the diagonal from the current one; a ballot finds how many diagonal
// steps follow at once and which of them match, and gap runs are measured
// the same way along their column or row. So a near-identical pair costs
// one round of loads per 32 steps instead of one per step. Runs come out
// length << 2 | op, last run first; no direction bit crosses to the host.
//
// What bounds it on an H100: operations by the roofline (a dozen integer
// operations a cell, a few bytes a problem in and out); in practice the
// instructions of one step of one warp, issued one dependent on the other:
// about 110 for a step of the full-matrix class at CW = 2.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFullWarps = 4;
// threads of the band class's block kernel
constexpr int kBandBlockThreads = 1024;
// shared memory one block may ask for
constexpr size_t kMaxShared = 227 * 1024;

enum Op : int { kEq = 0, kMis = 1, kDel = 2, kIns = 3 };

// Run-length CIGAR writer. Every lane of the warp runs it with the same
// values; the writer lane stores.
struct Runs {
  int32_t* out;
  bool writer;
  int count, op, len;

  __device__ __forceinline__ void emit(int o, int n) {
    if (n <= 0) return;
    if (o == op) {
      len += n;
      return;
    }
    flush();
    op = o;
    len = n;
  }
  __device__ __forceinline__ void flush() {
    if (len > 0) {
      if (writer) out[count] = (len << 2) | op;
      ++count;
    }
  }
};

// The reference's `_traceback` from (lp, lt), by one whole warp.
// `cell(i, j)` reads the bits of one cell and gives 0 for a cell that does
// not exist. Returns the number of runs written to `out`.
template <typename Cell>
__device__ int traceback(const Cell& cell, const uint8_t* __restrict__ pat,
                         const uint8_t* __restrict__ txt, int lp, int lt,
                         int32_t* __restrict__ out, int lane) {
  Runs r{out, lane == 0, 0, -1, 0};
  int i = lp, j = lt;
  while (i > 0 || j > 0) {
    // lane l looks l steps down the diagonal
    const int ii = i - lane, jj = j - lane;
    const bool inside = ii > 0 && jj > 0;
    int bt = 0;
    if (ii >= 0 && jj >= 0) bt = cell(ii, jj);
    const bool diag = inside && (bt & 3) == 0;
    const bool match = inside && pat[ii - 1] == txt[jj - 1];
    const unsigned not_diag = ~__ballot_sync(kFull, diag);
    const int f = not_diag ? __ffs(not_diag) - 1 : 32;
    unsigned m = __ballot_sync(kFull, match);
    // the f diagonal steps, run by run
    for (int left = f; left > 0;) {
      const bool eq = m & 1u;
      const unsigned flip = eq ? ~m : m;
      const int run = min(flip ? __ffs(flip) - 1 : 32, left);
      r.emit(eq ? kEq : kMis, run);
      m = run < 32 ? m >> run : 0u;
      left -= run;
    }
    i -= f;
    j -= f;
    if (f == 32 || (i == 0 && j == 0)) continue;
    bt = __shfl_sync(kFull, bt, f);  // the cell (i, j)
    int choice = bt & 3;
    if (i == 0) choice = 2;
    if (j == 0 && i > 0) choice = 1;
    if (choice == 1) {
      r.emit(kDel, 1);
      bool ext = bt & 4;
      --i;
      while (ext && i > 0) {
        // the cells up the column: each is visited while the one before
        // it extends
        const bool x = i - lane > 0 && (cell(i - lane, j) & 4);
        const unsigned stop = ~__ballot_sync(kFull, x);
        const int extending = stop ? __ffs(stop) - 1 : 32;
        const int n = min(extending + 1, min(i, 32));
        r.emit(kDel, n);
        ext = n < extending + 1;
        i -= n;
      }
    } else {
      r.emit(kIns, 1);
      bool ext = bt & 8;
      --j;
      while (ext && j > 0) {
        const bool x = j - lane > 0 && (cell(i, j - lane) & 8);
        const unsigned stop = ~__ballot_sync(kFull, x);
        const int extending = stop ? __ffs(stop) - 1 : 32;
        const int n = min(extending + 1, min(j, 32));
        r.emit(kIns, n);
        ext = n < extending + 1;
        j -= n;
      }
    }
  }
  r.flush();
  return r.count;
}

// N bytes of bits, kept as 32-bit words and stored as one word of N bytes
// (N = 2, 4, 8, 16) at an address that is a multiple of N.
template <int N>
struct BitsWord {
  uint32_t w[(N + 3) / 4];

  __device__ __forceinline__ BitsWord() {
#pragma unroll
    for (int q = 0; q < (N + 3) / 4; ++q) w[q] = 0;
  }
  __device__ __forceinline__ void set(int c, int bits) {
    w[c >> 2] |= static_cast<uint32_t>(bits) << (8 * (c & 3));
  }
  __device__ __forceinline__ void store(uint8_t* at) const {
    if constexpr (N == 2) {
      *reinterpret_cast<uint16_t*>(at) = static_cast<uint16_t>(w[0]);
    } else if constexpr (N == 4) {
      *reinterpret_cast<uint32_t*>(at) = w[0];
    } else if constexpr (N == 8) {
      *reinterpret_cast<uint2*>(at) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(at) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

__device__ __forceinline__ int pack(int value, bool flag) {
  return (value << 1) | (flag ? 1 : 0);
}

// pack(min(ext, open), ext < open): the smaller of 2 * ext + 1 and 2 *
// open, which is the first exactly when ext < open.
__device__ __forceinline__ int pack_min(int ext, int open) {
  return min(2 * ext + 1, 2 * open);
}

// Full-matrix class: one warp per problem, tiles of 32 * CW columns.
// `boundary` (dynamic shared memory, 2 * (pat_stride + 1) ints a warp) is
// only there when the text is wider than a tile.
template <int CW>
__global__ void __launch_bounds__(32 * kFullWarps)
e2e_full_kernel(const uint8_t* __restrict__ pattern, int pat_stride,
                const uint8_t* __restrict__ text, int text_stride,
                const int32_t* __restrict__ len_p,
                const int32_t* __restrict__ len_t, uint8_t* __restrict__ bits,
                size_t bits_size, int32_t* __restrict__ score,
                int32_t* __restrict__ runs, int32_t* __restrict__ n_runs,
                int batch, int warps, int mism, int gapo, int ge) {
  extern __shared__ int boundary[];
  constexpr int kTile = 32 * CW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * warps + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier below
  const int go_ge = gapo + ge;
  const int lp = max(0, min(len_p[b], pat_stride));
  const int lt = max(0, min(len_t[b], text_stride));
  const int n = lt + 1;
  const int rows1 = pat_stride + 1;
  const int steps = pat_stride + 31;  // of one tile, whatever lp
  const uint8_t* pat = pattern + static_cast<size_t>(b) * pat_stride;
  const uint8_t* txt = text + static_cast<size_t>(b) * text_stride;
  uint8_t* cell = bits + static_cast<size_t>(b) * bits_size;
  // a row's boundary: H of the tile's last column, and what the next
  // column takes as I
  int* bnd_h = boundary + warp * 2 * rows1;
  int* bnd_i = bnd_h + rows1;
  const bool tiled = n > kTile;

  int final_h = 0;
  int tile = 0;
  for (int t0 = 0; t0 < n; t0 += kTile, ++tile) {
    const int j0 = t0 + lane * CW;
    const bool feeds_next = t0 + kTile < n && lane == 31;
    uint8_t* tile_bits = cell + static_cast<size_t>(tile) * steps * kTile;
    int H[CW], D[CW];
    uint32_t tw[(CW + 3) / 4];  // text byte j-1 of column j, four to a word
#pragma unroll
    for (int q = 0; q < (CW + 3) / 4; ++q) tw[q] = 0;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int j = j0 + c;
      H[c] = j == 0 ? 0 : gapo + ge * j;
      D[c] = kInf;
      const uint32_t byte = j >= 1 && j <= lt ? txt[j - 1] : 0;
      tw[c >> 2] |= byte << (8 * (c & 3));
    }

    // what this lane hands to its right neighbour after a row: the old H
    // of its last column and the I entering the next column
    int out_h = 0, out_i = pack(kInf, false);
    // the pattern byte of the row a lane does next, loaded a step ahead
    int p_next = lane == 0 && lp > 0 ? pat[0] : 0;
    for (int s = 0; s < lp + 31; ++s) {
      const int i = s - lane + 1;
      const bool active = i >= 1 && i <= lp;
      const int p = p_next;
      p_next = i >= 0 && i < lp ? pat[i] : 0;
      int hl = __shfl_up_sync(kFull, out_h, 1);
      int in = __shfl_up_sync(kFull, out_i, 1);
      if (lane == 0) {
        hl = 0;  // column 0 has no diagonal
        in = pack(kInf, false);
        if (t0 > 0 && active) {
          hl = i == 1 ? gapo + ge * (t0 - 1) : bnd_h[i - 1];
          in = bnd_i[i];
        }
      }
      if (active) {
        BitsWord<CW> out;
        int iv = in >> 1;
        bool ext = in & 1;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = j0 + c;
          const int oh = H[c];
          // D: open vs extend, open wins ties
          const int d_ext = D[c] + ge;
          const int d_open = oh + go_ge;
          const bool te = d_ext < d_open;
          const int d_row = te ? d_ext : d_open;
          // diagonal: column j consumes text byte j-1
          int diag = kInf;
          if (j >= 1) {
            const bool match = ((tw[c >> 2] >> (8 * (c & 3))) & 0xFF) ==
                               static_cast<uint32_t>(p);
            diag = hl + (match ? 0 : mism);
          }
          // N: diagonal wins ties over D
          const bool td = d_row < diag;
          const int nv = td ? d_row : diag;
          const bool ti = iv < nv;
          H[c] = ti ? iv : nv;
          D[c] = d_row;
          out.set(c, (ti ? 2 : (td ? 1 : 0)) | (te ? 4 : 0) |
                         (ext || j == 0 ? 8 : 0));
          hl = oh;
          // I of the next column: open here wins ties over extending
          const int ipe = iv + ge;
          const int nop = nv + go_ge;
          ext = ipe < nop;
          iv = ext ? ipe : nop;
        }
        out_h = hl;
        out_i = pack(iv, ext);
        // the lanes of one step lie side by side: one store a warp
        out.store(tile_bits + static_cast<size_t>(s) * kTile + lane * CW);
        if (feeds_next) {
          bnd_h[i] = H[CW - 1];
          bnd_i[i] = out_i;
        }
      }
      // lane 31 writes a row's boundary 31 steps after lane 0 read it
      if (tiled) __syncwarp();
    }
    if (t0 + kTile >= n) {
      // H[lp][lt] sits in the last tile
      const int cf = lt % CW;
      int v = H[0];
#pragma unroll
      for (int c = 1; c < CW; ++c)
        if (c == cf) v = H[c];
      final_h = __shfl_sync(kFull, v, (lt - t0) / CW);
    }
  }
  __syncwarp();  // the bits of every lane, before any lane reads them

  auto at = [&](int i, int j) -> int {
    if (i == 0) return j == 0 ? 0 : (j == 1 ? 2 : (2 | 8));
    const int r = j % kTile;
    return cell[(static_cast<size_t>(j / kTile) * steps + (i - 1 + r / CW)) *
                    kTile + r];
  };
  int32_t* out = runs + static_cast<size_t>(b) * (pat_stride + text_stride);
  const int count = traceback(at, pat, txt, lp, lt, out, lane);
  if (lane == 0) {
    score[b] = final_h;
    n_runs[b] = count;
  }
}

// The geometry of one problem's band and of its bits.
struct Band {
  int lp, lt, w, lo, hi, wb, half;

  __device__ Band(int lp_, int lt_, int w_, int bits_stride)
      : lp(lp_), lt(lt_), w(w_) {
    lo = min(0, lt - lp) - w;
    hi = max(0, lt - lp) + w;
    wb = hi - lo + 1;
    half = band_half(bits_stride);
    if (wb > bits_stride) __trap();  // the wrapper sized the band's rows
  }
  // bytes of one anti-diagonal's row of bits: every second lane, padded
  // to 4 so that a lane's word is aligned
  __host__ __device__ static int band_half(int bits_stride) {
    return ((bits_stride + 1) / 2 + 3) & ~3;
  }
  __device__ __forceinline__ size_t slot(int i, int k) const {
    return static_cast<size_t>(2 * i + lo + k) * half + (k >> 1);
  }
  __device__ __forceinline__ bool certified(int total, int gapo,
                                            int ge) const {
    const int dt = lt >= lp ? lt - lp : lp - lt;
    return (lo <= -lp && hi >= lt) ||
           total < gapo + gapo + ge * (2 * w + 2 + dt);
  }
};

// One cell of the band, whatever holds its neighbours. dn: what (i-1, j)
// left for the cell below it, in: what (i, j-1) left for the cell to its
// right (both packed with their extend flag, INF where there is no such
// cell), h_diag: H of (i-1, j-1). INTERIOR: the caller knows i >= 1 and
// j >= 1.
template <bool INTERIOR>
struct BandCell {
  int h, dn, in, bits;

  __device__ __forceinline__ BandCell(int i, int j, int dn_up, int in_left,
                                      int h_diag, bool match, int mism,
                                      int gapo, int ge) {
    const int go_ge = gapo + ge;
    int nv, d_row, iv;
    if (!INTERIOR && i == 0) {
      // a leading insertion run; nothing reads this cell's I
      h = j == 0 ? 0 : gapo + ge * j;
      nv = h;
      d_row = kInf;
      iv = kInf;
      bits = j == 0 ? 0 : (j == 1 ? 2 : (2 | 8));
    } else {
      d_row = dn_up >> 1;
      const int diag =
          INTERIOR || j >= 1 ? h_diag + (match ? 0 : mism) : kInf;
      const bool td = d_row < diag;
      nv = td ? d_row : diag;
      iv = in_left >> 1;
      const bool ti = iv < nv;
      h = ti ? iv : nv;
      bits = (ti ? 2 : (td ? 1 : 0)) | ((dn_up & 1) << 2) |
             ((in_left & 1) << 3);
      if (!INTERIOR && j == 0) bits |= 8;
    }
    dn = pack_min(d_row + ge, h + go_ge);
    in = pack_min(iv + ge, nv + go_ge);
  }
};

// Band class, bands up to 32 * CW * WARPS lanes: a thread owns CW
// neighbouring band lanes and keeps their state in registers. On an
// anti-diagonal every second lane of the band holds a cell, so a step does
// CW / 2 cells a thread and needs one value from a neighbour thread: the I
// of the thread to the left on steps over the even band lanes, the D of
// the thread to the right on steps over the odd ones, by shuffle. Over two
// steps a thread stays on the same CW / 2 rows, then moves one row down;
// the pattern and text bytes it needs are two windows in registers that
// shift by a byte, loaded a pair of steps ahead. WARPS = 1: a warp per
// problem, four problems a block, no barrier. WARPS > 1: a block per
// problem; the value that crosses from one warp to the next goes through
// shared memory, one block barrier a step.
template <int CW, int WARPS>
__global__ void __launch_bounds__(32 * (WARPS == 1 ? kFullWarps : WARPS))
e2e_band_lanes_kernel(const uint8_t* __restrict__ pattern, int pat_stride,
                     const uint8_t* __restrict__ text, int text_stride,
                     const int32_t* __restrict__ len_p,
                     const int32_t* __restrict__ len_t,
                     const int32_t* __restrict__ band_w,
                     uint8_t* __restrict__ bits, int bits_stride,
                     int32_t* __restrict__ score, int32_t* __restrict__ runs,
                     int32_t* __restrict__ n_runs,
                     uint8_t* __restrict__ certified, int batch, int mism,
                     int gapo, int ge) {
  constexpr int M = CW / 2;  // cells a thread does in one step
  // what a warp's last thread leaves for the next warp (its I) and its
  // first thread for the warp before (its D), and the score
  __shared__ int s_edge_i[WARPS], s_edge_d[WARPS], s_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = WARPS == 1 ? blockIdx.x * kFullWarps + warp : blockIdx.x;
  // WARPS = 1: whole warps leave, and there is no block barrier below
  if (b >= batch) return;
  const int strip = WARPS == 1 ? lane : threadIdx.x;
  const Band band(max(0, min(len_p[b], pat_stride)),
                  max(0, min(len_t[b], text_stride)), max(0, band_w[b]),
                  bits_stride);
  const int lp = band.lp, lt = band.lt, lo = band.lo, wb = band.wb;
  // the launcher chose CW and WARPS from bits_stride
  if (wb > 32 * CW * WARPS) __trap();
  const uint8_t* pat = pattern + static_cast<size_t>(b) * pat_stride;
  const uint8_t* txt = text + static_cast<size_t>(b) * text_stride;
  uint8_t* cell = bits + static_cast<size_t>(b) *
                             (pat_stride + text_stride + 1) * band.half;
  const int k0 = strip * CW;
  const bool stores = k0 / 2 + M <= band.half;

  int H[CW], Dn[CW], In[CW];
#pragma unroll
  for (int x = 0; x < CW; ++x) {
    H[x] = kInf;
    Dn[x] = pack(kInf, false);
    In[x] = pack(kInf, false);
  }
  if constexpr (WARPS > 1) {
    if (lane == 0) {
      s_edge_i[warp] = pack(kInf, false);
      s_edge_d[warp] = pack(kInf, false);
    }
    __syncthreads();
  }
  auto pat_at = [&](int i) -> int { return i >= 0 && i < lp ? pat[i] : 0; };
  auto txt_at = [&](int j) -> int { return j >= 0 && j < lt ? txt[j] : 256; };
  // the step's cells are (ie - m, je + m), m = 0 .. M-1; pw[m] is pattern
  // byte ie - m - 1, tx[x] text byte je - 1 + x on the steps over even band
  // lanes and je - 2 + x on those over odd ones (the same rows, one column
  // on)
  const int first = (-lo) & 1;  // the parity of the band lanes of step 0
  int ie = (-lo - first - k0) >> 1;
  int pw[M], tx[M + 1];
#pragma unroll
  for (int m = 0; m < M; ++m) pw[m] = pat_at(ie - m - 1);
#pragma unroll
  for (int x = 0; x <= M; ++x) tx[x] = txt_at(-ie - 1 - first + x);
  int p_new = pat_at(ie), t_new = txt_at(-ie - first + M);

  auto step = [&](int a, auto parity, auto interior) {
    constexpr int PI = decltype(parity)::value;
    constexpr bool INTERIOR = decltype(interior)::value;
    // one value from the neighbour thread
    int from = PI == 0 ? __shfl_up_sync(kFull, In[CW - 1], 1)
                       : __shfl_down_sync(kFull, Dn[0], 1);
    if constexpr (WARPS > 1) {
      if (PI == 0 && lane == 0 && warp > 0) from = s_edge_i[warp - 1];
      if (PI == 1 && lane == 31 && warp + 1 < WARPS)
        from = s_edge_d[warp + 1];
    }
    BitsWord<M> out;
    int h_new[M], dn_new[M], in_new[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int x = PI + 2 * m;
      const int k = k0 + x;
      const int i = ie - m;
      const int j = a - i;
      int dn_up = x + 1 < CW ? Dn[x + 1 < CW ? x + 1 : 0] : from;
      if (k + 1 >= wb) dn_up = pack(kInf, false);
      int in_left = x >= 1 ? In[x >= 1 ? x - 1 : 0] : from;
      if ((!INTERIOR && j < 1) || k < 1) in_left = pack(kInf, false);
      const BandCell<INTERIOR> c(i, j, dn_up, in_left, H[x],
                                 pw[m] == tx[m + PI], mism, gapo, ge);
      h_new[m] = c.h;
      dn_new[m] = c.dn;
      in_new[m] = c.in;
      out.set(m, c.bits);
    }
    // the cells of one anti-diagonal run at once: none reads what another
    // of them writes
#pragma unroll
    for (int m = 0; m < M; ++m) {
      H[PI + 2 * m] = h_new[m];
      Dn[PI + 2 * m] = dn_new[m];
      In[PI + 2 * m] = in_new[m];
    }
    if (stores)
      out.store(cell + static_cast<size_t>(a) * band.half + k0 / 2);
    if constexpr (WARPS > 1) {
      if (PI == 1 && lane == 31) s_edge_i[warp] = In[CW - 1];
      if (PI == 0 && lane == 0) s_edge_d[warp] = Dn[0];
      __syncthreads();
    }
  };
  // a lane moves one row down before every step over the even band lanes
  auto advance = [&]() {
    ++ie;
#pragma unroll
    for (int m = M - 1; m > 0; --m) pw[m] = pw[m - 1];
    pw[0] = p_new;
#pragma unroll
    for (int x = 0; x < M; ++x) tx[x] = tx[x + 1];
    tx[M] = t_new;
  };
  using Even = std::integral_constant<int, 0>;
  using Odd = std::integral_constant<int, 1>;

  // on the steps from `inner` to `inner_end` every band lane's cell has
  // 1 <= i <= lp and 1 <= j <= lt: no row 0, no column 0, nothing outside
  const int inner = max(band.hi + 2, 2 - lo);
  const int inner_end = min(2 * lp + lo, 2 * lt - band.hi);
  using Edge = std::false_type;
  using Inner = std::true_type;

  int a = 0;
  if (first == 1) {
    step(a, Odd(), Edge());
    ++a;
    advance();
  }
  for (; a <= lp + lt; a += 2) {
    // the bytes that enter the windows after this pair of steps: pattern
    // row ie + 1 and the text byte one past the window
    p_new = pat_at(ie);
    t_new = txt_at(a - ie + M);
    if (a >= inner && a + 1 <= inner_end) {
      step(a, Even(), Inner());
      step(a + 1, Odd(), Inner());
    } else {
      step(a, Even(), Edge());
      if (a + 1 <= lp + lt) step(a + 1, Odd(), Edge());
    }
    advance();
  }
  const int k_end = lt - lp - lo;
  int v = H[0];
#pragma unroll
  for (int x = 1; x < CW; ++x)
    if (x == k_end % CW) v = H[x];
  // the score, and the bits of every thread before any thread reads them
  int total;
  if constexpr (WARPS > 1) {
    if (strip == k_end / CW) s_total = v;
    __syncthreads();
    if (warp > 0) return;
    total = s_total;
  } else {
    __syncwarp();
    total = __shfl_sync(kFull, v, k_end / CW);
  }
  auto at = [&](int i, int j) -> int {
    const int k = j - i - lo;
    return k < 0 || k >= wb ? 0 : cell[band.slot(i, k)];
  };
  int32_t* out = runs + static_cast<size_t>(b) * (pat_stride + text_stride);
  const int count = traceback(at, pat, txt, lp, lt, out, lane);
  if (lane == 0) {
    score[b] = total;
    n_runs[b] = count;
    certified[b] = band.certified(total, gapo, ge) ? 1 : 0;
  }
}

// Band class, bands over 4096 lanes: one block per problem, the cells of an
// anti-diagonal dealt out to its threads, a block barrier a step. `state`
// (dynamic shared memory): three arrays of 2 * half ints, the even band
// lanes in the first half and the odd ones in the second, so that the
// lanes of one anti-diagonal (every second k) lie side by side.
__global__ void __launch_bounds__(kBandBlockThreads)
e2e_band_block_kernel(const uint8_t* __restrict__ pattern, int pat_stride,
                      const uint8_t* __restrict__ text, int text_stride,
                      const int32_t* __restrict__ len_p,
                      const int32_t* __restrict__ len_t,
                      const int32_t* __restrict__ band_w,
                      uint8_t* __restrict__ bits, int bits_stride,
                      int32_t* __restrict__ score,
                      int32_t* __restrict__ runs,
                      int32_t* __restrict__ n_runs,
                      uint8_t* __restrict__ certified, int mism, int gapo,
                      int ge) {
  extern __shared__ int state[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const Band band(max(0, min(len_p[b], pat_stride)),
                  max(0, min(len_t[b], text_stride)), max(0, band_w[b]),
                  bits_stride);
  const int lp = band.lp, lt = band.lt, lo = band.lo, hi = band.hi,
            wb = band.wb, half = band.half;
  int* s_h = state;
  int* s_d = state + 2 * half;
  int* s_i = state + 4 * half;
  const uint8_t* pat = pattern + static_cast<size_t>(b) * pat_stride;
  const uint8_t* txt = text + static_cast<size_t>(b) * text_stride;
  uint8_t* cell =
      bits + static_cast<size_t>(b) * (pat_stride + text_stride + 1) * half;
  auto slot = [half](int k) { return (k >> 1) + (k & 1) * half; };

  for (int a = 0; a <= lp + lt; ++a) {
    // cells (i, a - i) inside the matrix and the band: k = a - lo - 2i
    const int i_min = max(max(0, a - lt), (a - hi + 1) >> 1);
    const int i_max = min(min(lp, a), (a - lo) >> 1);
    for (int i = i_min + tid; i <= i_max; i += kBandBlockThreads) {
      const int j = a - i;
      const int k = j - i - lo;
      // D from (i-1, j), lane k+1 of the last anti-diagonal; I from (i,
      // j-1), lane k-1 of it; the diagonal from this lane two before
      const int dn_up = i >= 1 && k + 1 < wb ? s_d[slot(k + 1)]
                                             : pack(kInf, false);
      const int in_left = i >= 1 && j >= 1 && k >= 1 ? s_i[slot(k - 1)]
                                                      : pack(kInf, false);
      const bool both = i >= 1 && j >= 1;
      const BandCell<false> c(i, j, dn_up, in_left, both ? s_h[slot(k)] : 0,
                              both && txt[j - 1] == pat[i - 1], mism, gapo,
                              ge);
      s_h[slot(k)] = c.h;
      s_d[slot(k)] = c.dn;
      s_i[slot(k)] = c.in;
      cell[band.slot(i, k)] = static_cast<uint8_t>(c.bits);
    }
    __syncthreads();
  }
  if (tid >= 32) return;

  const int total = s_h[slot(lt - lp - lo)];
  auto at = [&](int i, int j) -> int {
    const int k = j - i - lo;
    return k < 0 || k >= wb ? 0 : cell[band.slot(i, k)];
  };
  int32_t* out = runs + static_cast<size_t>(b) * (pat_stride + text_stride);
  const int count = traceback(at, pat, txt, lp, lt, out, tid);
  if (tid == 0) {
    score[b] = total;
    n_runs[b] = count;
    certified[b] = band.certified(total, gapo, ge) ? 1 : 0;
  }
}

template <int CW>
cudaError_t launch_full(const uint8_t* pattern, int pat_stride,
                        const uint8_t* text, int text_stride,
                        const int32_t* len_p, const int32_t* len_t,
                        uint8_t* bits, size_t bits_size, int32_t* score,
                        int32_t* runs, int32_t* n_runs, int batch, int mism,
                        int gapo, int ge, cudaStream_t stream) {
  constexpr int kTile = 32 * CW;
  const size_t tiles = (text_stride + 1 + kTile - 1) / kTile;
  if (bits_size < tiles * (pat_stride + 31) * kTile || bits_size % 16 != 0)
    return cudaErrorInvalidValue;
  int warps = kFullWarps;
  size_t per_warp = 0;
  if (tiles > 1)
    per_warp = 2 * sizeof(int) * static_cast<size_t>(pat_stride + 1);
  while (warps > 1 && warps * per_warp > kMaxShared) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        e2e_full_kernel<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  e2e_full_kernel<CW><<<(batch + warps - 1) / warps, 32 * warps, smem,
                        stream>>>(pattern, pat_stride, text, text_stride,
                                  len_p, len_t, bits, bits_size, score, runs,
                                  n_runs, batch, warps, mism, gapo, ge);
  return cudaGetLastError();
}

template <int CW, int WARPS>
cudaError_t launch_band_lanes(const uint8_t* pattern, int pat_stride,
                              const uint8_t* text, int text_stride,
                              const int32_t* len_p, const int32_t* len_t,
                              const int32_t* band_w, uint8_t* bits,
                              int bits_stride, int32_t* score, int32_t* runs,
                              int32_t* n_runs, uint8_t* certified, int batch,
                              int mism, int gapo, int ge,
                              cudaStream_t stream) {
  constexpr int kWarps = WARPS == 1 ? kFullWarps : WARPS;
  const int blocks = WARPS == 1 ? (batch + kWarps - 1) / kWarps : batch;
  e2e_band_lanes_kernel<CW, WARPS><<<blocks, 32 * kWarps, 0, stream>>>(
      pattern, pat_stride, text, text_stride, len_p, len_t, band_w, bits,
      bits_stride, score, runs, n_runs, certified, batch, mism, gapo, ge);
  return cudaGetLastError();
}

cudaError_t launch_band_block(const uint8_t* pattern, int pat_stride,
                              const uint8_t* text, int text_stride,
                              const int32_t* len_p, const int32_t* len_t,
                              const int32_t* band_w, uint8_t* bits,
                              int bits_stride, int32_t* score, int32_t* runs,
                              int32_t* n_runs, uint8_t* certified, int batch,
                              int mism, int gapo, int ge,
                              cudaStream_t stream) {
  const size_t smem = 6 * sizeof(int) *
                      static_cast<size_t>(Band::band_half(bits_stride));
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        e2e_band_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  e2e_band_block_kernel<<<batch, kBandBlockThreads, smem, stream>>>(
      pattern, pat_stride, text, text_stride, len_p, len_t, band_w, bits,
      bits_stride, score, runs, n_runs, certified, mism, gapo, ge);
  return cudaGetLastError();
}

}  // namespace

// The strip of the full-matrix class for a text of text_stride bytes: 2, 4,
// 8 or 16 columns a lane, tiles of 32 strips.
extern "C" int trgt_e2e_strip(int text_stride) {
  const int n = text_stride + 1;
  return n <= 64 ? 2 : (n <= 128 ? 4 : (n <= 256 ? 8 : 16));
}

// Full-matrix class. pattern: (B, pat_stride) bytes; text: (B,
// text_stride) bytes; len_p, len_t: (B,) lengths (clamped to the strides);
// bits: bits_size bytes a problem, a multiple of 16 and at least tiles *
// (pat_stride + 31) * 32 * CW with CW = trgt_e2e_strip(text_stride) and
// tiles = ceil((text_stride + 1) / (32 * CW)); cell (i, j), i >= 1, is the
// byte ((j / (32*CW)) * (pat_stride + 31) + i - 1 + (j % (32*CW)) / CW) *
// 32*CW + j % (32*CW), row 0 is not stored; score: (B,); runs: (B,
// pat_stride + text_stride) ints, each length << 2 | op (0 '=', 1 'X', 2
// 'D', 3 'I'), the alignment's last run first; n_runs: (B,). More than one
// tile needs 8 * (pat_stride + 1) bytes of shared memory a warp, so at
// most 29055 pattern bytes. Returns the launch's cudaGetLastError().
extern "C" int trgt_e2e_scan(const uint8_t* pattern, int pat_stride,
                             const uint8_t* text, int text_stride,
                             const int32_t* len_p, const int32_t* len_t,
                             uint8_t* bits, size_t bits_size, int32_t* score,
                             int32_t* runs, int32_t* n_runs, int batch,
                             int mism, int gapo, int ge, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define TRGT_FULL(CW)                                                       \
  launch_full<CW>(pattern, pat_stride, text, text_stride, len_p, len_t,    \
                  bits, bits_size, score, runs, n_runs, batch, mism, gapo, \
                  ge, st)
  switch (trgt_e2e_strip(text_stride)) {
    case 2:
      e = TRGT_FULL(2);
      break;
    case 4:
      e = TRGT_FULL(4);
      break;
    case 8:
      e = TRGT_FULL(8);
      break;
    default:
      e = TRGT_FULL(16);
  }
#undef TRGT_FULL
  return static_cast<int>(e);
}

// Bytes of one anti-diagonal's row of the band class's bits.
extern "C" int trgt_e2e_band_half(int bits_stride) {
  return Band::band_half(bits_stride);
}

// Band class. As above, and band_w: (B,) band slack W of each problem;
// bits_stride: the lanes of the widest band, at least every problem's
// |len_t - len_p| + 2W + 1 (the kernel traps otherwise) and at most 19360
// (three ints a band lane in shared memory); bits: (pat_stride +
// text_stride + 1) * half bytes a problem, half =
// trgt_e2e_band_half(bits_stride); cell (i, j) with k = j - i - lo is the
// byte (i + j) * half + k / 2; only cells inside the matrix and the band
// mean anything; certified: (B,) bytes. Returns the launch's
// cudaGetLastError().
extern "C" int trgt_e2e_band(const uint8_t* pattern, int pat_stride,
                             const uint8_t* text, int text_stride,
                             const int32_t* len_p, const int32_t* len_t,
                             const int32_t* band_w, uint8_t* bits,
                             int bits_stride, int32_t* score, int32_t* runs,
                             int32_t* n_runs, uint8_t* certified, int batch,
                             int mism, int gapo, int ge, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define TRGT_BAND_ARGS                                                     \
  pattern, pat_stride, text, text_stride, len_p, len_t, band_w, bits,     \
      bits_stride, score, runs, n_runs, certified, batch, mism, gapo, ge
#define TRGT_BAND_LANES(CW, WARPS) \
  launch_band_lanes<CW, WARPS>(TRGT_BAND_ARGS, st)
  if (bits_stride <= 128)
    e = TRGT_BAND_LANES(4, 1);
  else if (bits_stride <= 256)
    e = TRGT_BAND_LANES(4, 2);
  else if (bits_stride <= 512)
    e = TRGT_BAND_LANES(4, 4);
  else if (bits_stride <= 1024)
    e = TRGT_BAND_LANES(4, 8);
  else if (bits_stride <= 2048)
    e = TRGT_BAND_LANES(8, 8);
  else if (bits_stride <= 4096)
    e = TRGT_BAND_LANES(8, 16);
  else
    e = launch_band_block(TRGT_BAND_ARGS, st);
#undef TRGT_BAND_LANES
#undef TRGT_BAND_ARGS
  return static_cast<int>(e);
}
