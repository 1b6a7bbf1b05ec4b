// Batched HMM Viterbi with traceback (annotate stage of `genotype`).
//
// Replaces trgt_tpu/kernels/viterbi.py `_viterbi_full` with `_forward`, an
// XLA `lax.scan` over positions (not Pallas): in eager PyTorch the same
// scan would cost several launches per position, and alleles reach 10 kb.
//
// Semantics (identical to `_forward` / `_viterbi_full`):
//   position 0: edge-less emitting states seed with their emission;
//   every later position: one relax best[dst] = max_src(col[src] +
//   T[dst, src]) over all states, predecessor = the source with the
//   smallest edge rank R among the sources that tie the max (first max
//   in edge-list order), then `+ em`, then the silent levels one after
//   another, each a relax over the current column. fp32 throughout, in
//   the reference's add order (col + T, then + em); the silent closure is
//   never precomposed, which would flip structural ties.
//   The traceback walks back from (len-1, end state) as `back_step` does
//   and writes the same (L+1, B, K) segments plus the `ok` row.
//
// Design: one block per batch row, one thread per state (up to
// kMaxPerThread states per thread for very large topologies). The current
// column lives in shared memory, double-buffered; the row's transposed T
// and R tables and its emissions are copied to shared memory when S*S
// fits, so the relax loop reads a broadcast col[src] and a conflict-free
// T[src][dst]. The relax across positions is dense (every state, one pass
// over all sources keeping the max and the minimum tie rank together). The
// silent levels (a motif of m bases has a chain of m-1 delete states, so
// ~m levels) run on warp 0 alone, one lane per state over that state's
// in-edges, separated by warp barriers instead of block barriers.
// Predecessors and valid flags go to a (L, B, S) uint16 buffer (bit 15 =
// valid) that one thread walks back at the end.
//
// What bounds it on an H100: the position loop is serial, so a row costs
// L times (one S-wide relax per thread + ~m short warp steps + two block
// barriers); a batch needs many rows in flight to fill the card.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPerThread = 4;
constexpr float kNeg = -1e30f;
constexpr float kHalfNeg = -5e29f;
constexpr int kNoRank = 0x7FFF;

// Running relax state over a set of sources: the max candidate, the
// smallest edge rank among the sources equal to it, and that source.
struct Best {
  float v;
  int r;
  int p;
};

__device__ __forceinline__ void best_add(Best& b, float c, int r, int src) {
  if (c > b.v) {
    b.v = c;
    b.r = r;
    b.p = src;
  } else if (c == b.v && r < b.r) {
    b.r = r;
    b.p = src;
  }
}

// best = max_src(col[src] + T[src][dst]) over all sources. In one pass it
// also keeps the first source of minimum rank among the
// sources equal to the max, where a non-edge ranks kNoRank. `_forward`'s
// argmin over `where(tie, R, NO_RANK)` returns index 0 when every tie is
// a non-edge, hence `pred_of`.
__device__ __forceinline__ Best relax(const float* col, const float* Tt,
                                      const int16_t* Rt, int S, int dst) {
  Best b{-INFINITY, 0x7FFFFFFF, 0};
#pragma unroll 4
  for (int src = 0; src < S; ++src) {
    const float c = col[src] + Tt[src * S + dst];
    best_add(b, c, Rt[src * S + dst], src);
  }
  return b;
}

__device__ __forceinline__ int pred_of(const Best& b) {
  return b.r >= kNoRank ? 0 : b.p;
}

__global__ void viterbi_kernel(
    const int8_t* __restrict__ tokens, int L, int B,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ u_map, const float* __restrict__ Tt_all,
    const int16_t* __restrict__ Rt_all, const float* __restrict__ em_all,
    const uint8_t* __restrict__ silent_all,
    const uint8_t* __restrict__ has_edges_all,
    const uint8_t* __restrict__ no_edge_emit_all,
    const uint8_t* __restrict__ level_masks_all, int S, int num_levels,
    int silent_edge_cap, int tables_in_smem, uint16_t* __restrict__ pv,
    int16_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* col = smem;            // (S)
  float* nxt = col + S;         // (S)
  float* em = nxt + S;          // (S, 5)
  float* lv_val = em + 5 * S;   // (S) new values of one silent level
  int* spred = reinterpret_cast<int*>(lv_val + S);  // (S)
  int* svalid = spred + S;      // (S)
  int* slevel = svalid + S;     // (S) silent level of each state, or -1
  int* lv_states = slevel + S;  // (S) silent states ordered by level
  int* e_off = lv_states + S;   // (S + 1) in-edges of lv_states[i]: CSR
  int* lv_off = e_off + S + 1;  // (num_levels + 1)
  int* e_src = lv_off + num_levels + 1;  // (silent_edge_cap)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nt = blockDim.x;
  const int u = u_map[b];
  const int len = lens[b];
  const int K = num_levels + 1;
  const size_t SS = static_cast<size_t>(S) * S;

  const float* Tt = Tt_all + u * SS;
  const int16_t* Rt = Rt_all + u * SS;
  if (tables_in_smem) {
    float* sT = reinterpret_cast<float*>(e_src + silent_edge_cap);
    int16_t* sR = reinterpret_cast<int16_t*>(sT + SS);
    for (size_t i = tid; i < SS; i += nt) {
      sT[i] = Tt[i];
      sR[i] = Rt[i];
    }
    Tt = sT;
    Rt = sR;
  }
  for (int i = tid; i < 5 * S; i += nt) em[i] = em_all[u * 5 * S + i];
  const uint8_t* silent = silent_all + u * S;

  int n_own = 0;
  int own[kMaxPerThread];
  bool sil[kMaxPerThread], has_edges[kMaxPerThread], seed[kMaxPerThread];
  for (int d = tid; d < S; d += nt) {
    const int q = n_own++;
    own[q] = d;
    int level = -1;
    for (int li = 0; li < num_levels; ++li)
      if (level_masks_all[(static_cast<size_t>(u) * num_levels + li) * S +
                          d])
        level = li;
    slevel[d] = level;
    sil[q] = silent[d] != 0;
    has_edges[q] = has_edges_all[u * S + d] != 0;
    seed[q] = no_edge_emit_all[u * S + d] != 0;
  }
  // rows past len are never walked: segments -1
  for (size_t i = tid; i < static_cast<size_t>(L - len) * K; i += nt) {
    const size_t t = len + i / K;
    out[(t * B + b) * K + i % K] = -1;
  }
  __syncthreads();
  if (tid == 0) {
    // silent states in level order, and CSR offsets of their in-edges
    int n = 0;
    int e = 0;
    for (int li = 0; li < num_levels; ++li) {
      lv_off[li] = n;
      for (int d = 0; d < S; ++d) {
        if (slevel[d] != li) continue;
        e_off[n] = e;
        lv_states[n++] = d;
        for (int src = 0; src < S; ++src)
          e += Rt[src * S + d] < kNoRank ? 1 : 0;
      }
    }
    lv_off[num_levels] = n;
    e_off[n] = e;
  }
  __syncthreads();
  // each silent state's in-edges sorted by edge rank (insertion sort:
  // in-degrees are a handful)
  for (int i = tid; i < lv_off[num_levels]; i += nt) {
    const int d = lv_states[i];
    const int lo = e_off[i];
    int hi = lo;
    for (int src = 0; src < S; ++src) {
      const int r = Rt[src * S + d];
      if (r >= kNoRank) continue;
      int k = hi++;
      while (k > lo && Rt[e_src[k - 1] * S + d] > r) {
        e_src[k] = e_src[k - 1];
        --k;
      }
      e_src[k] = src;
    }
  }
  __syncthreads();

  const int8_t* tok = tokens + static_cast<size_t>(b) * L;
  for (int t = 0; t < len; ++t) {
    const int sym = tok[t];
    for (int q = 0; q < n_own; ++q) {
      const int d = own[q];
      float v;
      int pred;
      bool ok;
      if (t == 0) {
        // only edge-less emitting states seed
        v = seed[q] ? em[d * 5 + sym] : kNeg;
        pred = d;
        ok = seed[q] && v > kHalfNeg;
      } else {
        const Best bb = relax(col, Tt, Rt, S, d);
        const float c = sil[q] ? kNeg : bb.v + em[d * 5 + sym];
        ok = !sil[q] && has_edges[q] && c > kHalfNeg;
        v = ok ? c : kNeg;
        pred = pred_of(bb);
      }
      nxt[d] = v;
      spred[d] = pred;
      svalid[d] = ok;
    }
    __syncthreads();
    if (tid < 32) {
      // silent levels one after another on warp 0, one lane per state.
      // A level only changes a state's value and predecessor when its
      // best is valid, and for a valid state the max over its in-edges
      // equals the dense max (non-edges sit at NEG), so the relax runs
      // over the in-edges in rank order: the first max is the dense
      // kernel's minimum-rank tie
      for (int li = 0; li < num_levels; ++li) {
        for (int i = lv_off[li] + lane; i < lv_off[li + 1]; i += 32) {
          const int d = lv_states[i];
          float best = -INFINITY;
          int p = 0;
          for (int e = e_off[i]; e < e_off[i + 1]; ++e) {
            const int src = e_src[e];
            const float c = nxt[src] + Tt[src * S + d];
            if (c > best) {
              best = c;
              p = src;
            }
          }
          const bool ok = best > kHalfNeg;
          lv_val[i] = ok ? best : kNeg;
          if (ok) spred[d] = p;
          svalid[d] = ok;
        }
        __syncwarp();
        for (int i = lv_off[li] + lane; i < lv_off[li + 1]; i += 32)
          nxt[lv_states[i]] = lv_val[i];
        __syncwarp();
      }
    }
    __syncthreads();
    uint16_t* pv_t = pv + (static_cast<size_t>(t) * B + b) * S;
    for (int q = 0; q < n_own; ++q) {
      const int d = own[q];
      pv_t[d] = static_cast<uint16_t>(spred[d] | (svalid[d] ? 0x8000 : 0));
    }
    float* tmp = col;
    col = nxt;
    nxt = tmp;
  }
  __syncthreads();

  if (tid == 0) {
    // back_step: arm at (len-1, end state); each column walks its silent
    // chain (at most K states) down to the emitting state, whose
    // predecessor enters column t-1
    bool ok = true;
    int cur = ends[b];
    for (int t = len - 1; t >= 0; --t) {
      const uint16_t* pv_t = pv + (static_cast<size_t>(t) * B + b) * S;
      int16_t* seg = out + (static_cast<size_t>(t) * B + b) * K;
      int s = cur;
      int next = cur;
      bool alive = true;
      for (int k = 0; k < K; ++k) {
        if (!alive) {
          seg[k] = -1;
          continue;
        }
        const uint16_t w = pv_t[s];
        const int pred_s = w & 0x7FFF;
        seg[k] = static_cast<int16_t>(s);
        ok = ok && (w & 0x8000) != 0;
        if (silent[s]) {
          s = pred_s;
        } else {
          next = pred_s;
          alive = false;
        }
      }
      // a silent chain longer than K would keep a stale state
      ok = ok && !alive;
      cur = next;
    }
    int16_t* ok_row = out + (static_cast<size_t>(L) * B + b) * K;
    for (int k = 0; k < K; ++k) ok_row[k] = ok ? 1 : 0;
  }
}

}  // namespace

// tokens: (B, L) int8 symbols; lens, ends, u_map: (B,); Tt, Rt: (U, S, S)
// transposed tables ([src][dst]); em: (U, S, 5); silent, has_edges,
// no_edge_emit: (U, S) bytes; level_masks: (U, num_levels, S) bytes;
// silent_edge_cap: the most edges into silent-level states of any
// topology; pv: (L, B, S) scratch; out: (L+1, B, K) segments + ok row.
// smem_bytes is the dynamic shared memory the wrapper sized (tables
// included when tables_in_smem). Returns the launch's cudaGetLastError().
extern "C" int trgt_viterbi(const int8_t* tokens, int L, int B,
                            const int32_t* lens, const int32_t* ends,
                            const int32_t* u_map, const float* Tt,
                            const int16_t* Rt, const float* em,
                            const uint8_t* silent, const uint8_t* has_edges,
                            const uint8_t* no_edge_emit,
                            const uint8_t* level_masks, int S,
                            int num_levels, int silent_edge_cap,
                            int tables_in_smem, int smem_bytes, int threads,
                            void* pv, int16_t* out, void* stream) {
  if (B <= 0) return 0;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  viterbi_kernel<<<B, threads, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      tokens, L, B, lens, ends, u_map, Tt, Rt, em, silent, has_edges,
      no_edge_emit, level_masks, S, num_levels, silent_edge_cap,
      tables_in_smem,
      static_cast<uint16_t*>(pv), out);
  return static_cast<int>(cudaGetLastError());
}
