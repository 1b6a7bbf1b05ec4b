// Batched HMM Viterbi with traceback (annotate stage and impure-read
// filter of `genotype`).
//
// Replaces trgt_tpu/kernels/viterbi.py `_viterbi_full` with `_forward`, an
// XLA `lax.scan` over positions (not Pallas): in eager PyTorch the same
// scan would cost several launches per position, and alleles reach 10 kb.
//
// Semantics (identical to `_forward` / `_viterbi_full`):
//   position 0: edge-less emitting states seed with their emission;
//   every later position: one relax best[dst] = max_src(col[src] +
//   T[dst, src]) over all states, predecessor = the source with the
//   smallest edge rank among the sources that tie the max (first max in
//   edge-list order), then `+ em`, then the silent levels one after
//   another, each a relax over the current column. fp32 throughout, in
//   the reference's add order (col + T, then + em); the silent closure is
//   never precomposed, which would flip structural ties.
//   The traceback walks back from (len-1, end state) as `back_step` does
//   and writes the same (L+1, B, K) segments plus the `ok` row.
//
// The reference relaxes densely over all S sources. This kernel relaxes
// over each state's in-edge list, in rank order with a strict `>`, and
// gives the same words for every state, valid or not:
//   - some source is valid over a real edge: the max is a real value, only
//     edges tie it, the first in rank order is the minimum-rank tie;
//   - none is: a candidate is NEG (one of source and edge is NEG) or
//     2*NEG (both are), exactly, in fp32. If the list's max is NEG, so is
//     the dense max, and the edges that tie it are the list's maxima. If
//     it is 2*NEG (every edge has zero probability and an invalid source)
//     the dense max is NEG as soon as any state of the column is valid,
//     all ties are then non-edges and the reference's argmin returns state
//     0; with no valid state the dense max is 2*NEG too and the first
//     edge wins. A state without edges gets 0. "Any state valid" equals
//     "any emitting state valid" (a silent state is valid only over a
//     valid source), one warp vote per position.
//
// What bounds it on an H100: the position loop is serial, and inside a
// position the silent states form a dependency chain (a motif of m bases
// has m-1 delete states in a row, then motif end, run end, run start,
// motif starts). The bytes and operations are tiny beside that latency.
//
// Design: one warp per batch row, up to four rows per block, no block
// barrier anywhere; `__syncwarp` is the only barrier. A row's state lives
// in its warp's slice of shared memory: the previous and the current
// column, the emissions, and 4-wide in-edge tables copied once from the
// CSR the host built per topology, padded with edges of value -inf, which
// never win, so the relax needs no per-edge branch (edges past the fourth
// of a state are read from the CSR itself). Per position:
//   1. lane l relaxes states l, l+32, ... over the previous column: one
//      8-byte and one 16-byte load fetch a state's four sources and
//      values, then four column loads go out together;
//   2. the silent states follow the host's schedule (viterbi_tables.py):
//      a few phases of at most 32 states, a lane each. A lane relaxes its
//      state over the sources that are final, all but at most one: its
//      chain source, a state of the same phase one step earlier. Then the
//      chain values travel from lane to lane by shuffle, one step at a
//      time, and each lane settles its state when its step comes: in rank
//      order the best edge before the chain edge, the chain edge, the
//      best after it. Only the value travels (the max of the three, or
//      NEG), so a motif's delete chain costs a shuffle, an add and a max
//      per link, with no barrier and no shared-memory round trip between
//      links; which edge won is settled once, after the last step;
//   3. the S predecessor words (bit 15 = valid, bit 14 = the state is
//      silent) leave as coalesced 64-byte lines into a (B, L, S) buffer.
// Tokens are fetched 32 positions at a time, one per lane. The traceback
// stays in the kernel: the warp copies the words of a chunk of positions
// (32 where shared memory allows) into shared memory asynchronously
// while it walks the chunk after it, all lanes alike, one load per step
// (the word says whether its state is silent), and a position's segment
// leaves as one store.

#include <cmath>
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kHalfNeg = -5e29f;
// under NEG and over 2*NEG: tells the two apart
constexpr float kDeepNeg = -1.5e30f;
constexpr int kEll = 4;
constexpr int kMaxWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kSilent = 1, kHasEdges = 2, kSeed = 4, kTail = 8;
// predecessor word: 14 bits of state, then silent, then valid
constexpr int kWordSilent = 0x4000, kWordValid = 0x8000, kWordPred = 0x3FFF;
// schedule slot, first word: the state, whether it has more than kEll
// in-edges, its step in the phase and its chain source's lane + 1
constexpr int kSlotTail = 0x4000;
constexpr int kSlotStepShift = 16, kSlotLaneShift = 24;

// One warp's slice of shared memory.
struct Slice {
  uint16_t* stage;     // (2, chunk, Sp) positions' words, for the traceback
  float4* ell_lp;      // (S) a state's first kEll in-edge values
  float4* sl_lp;       // (NS) the same by schedule slot
  int2* ell_src;       // (S) the sources, four int16
  int2* sl_src;        // (NS)
  int2* sl_meta;       // (NS) slot word (see kSlot*), chain edge's place
  float* col0;         // (S)
  float* col1;         // (S)
  float* em;           // (S, 5)
  int16_t* ph_off;     // (P + 1)
  int16_t* ph_depth;   // (P)
  uint16_t* word;      // (S) the position's predecessor words
  uint8_t* flags;      // (S)
};

__host__ __device__ inline int round8(int x) { return (x + 7) / 8 * 8; }

__host__ __device__ inline size_t slice_bytes(int S, int NS, int P,
                                              int chunk) {
  const size_t bytes = 2 * 2 * static_cast<size_t>(chunk) * round8(S) +
                       (16 + 8) * static_cast<size_t>(S + NS) +
                       8 * static_cast<size_t>(NS) +
                       4 * static_cast<size_t>(7 * S) +
                       2 * static_cast<size_t>(2 * P + 1 + S) + S;
  return (bytes + 15) / 16 * 16;
}

__device__ inline Slice carve(unsigned char* base, int S, int NS, int P,
                              int chunk) {
  Slice s;
  s.stage = reinterpret_cast<uint16_t*>(base);
  s.ell_lp = reinterpret_cast<float4*>(s.stage + 2 * chunk * round8(S));
  s.sl_lp = s.ell_lp + S;
  s.ell_src = reinterpret_cast<int2*>(s.sl_lp + NS);
  s.sl_src = s.ell_src + S;
  s.sl_meta = s.sl_src + NS;
  s.col0 = reinterpret_cast<float*>(s.sl_meta + NS);
  s.col1 = s.col0 + S;
  s.em = s.col1 + S;
  s.ph_off = reinterpret_cast<int16_t*>(s.em + 5 * S);
  s.ph_depth = s.ph_off + P + 1;
  s.word = reinterpret_cast<uint16_t*>(s.ph_depth + P);
  s.flags = reinterpret_cast<uint8_t*>(s.word + S);
  return s;
}

// The first max in list order.
struct Best {
  float v;
  int p;
};

__device__ __forceinline__ void best_add(Best& b, float c, int src) {
  if (c > b.v) {
    b.v = c;
    b.p = src;
  }
}

// A state's first kEll in-edges; missing ones are (state 0, -inf).
struct Edges {
  int src[kEll];
  float lp[kEll];
};

__device__ __forceinline__ Edges unpack(const int2 sv, const float4 lp) {
  Edges e;
  e.src[0] = sv.x & 0xFFFF;
  e.src[1] = static_cast<unsigned>(sv.x) >> 16;
  e.src[2] = sv.y & 0xFFFF;
  e.src[3] = static_cast<unsigned>(sv.y) >> 16;
  e.lp[0] = lp.x;
  e.lp[1] = lp.y;
  e.lp[2] = lp.z;
  e.lp[3] = lp.w;
  return e;
}

// Copy a state's first kEll in-edges from the CSR, padded.
__device__ __forceinline__ void pack_edges(const int16_t* e_src,
                                           const float* e_lp, int lo, int dg,
                                           int2* src_out, float4* lp_out) {
  int sv[kEll];
  float lp[kEll];
#pragma unroll
  for (int e = 0; e < kEll; ++e) {
    sv[e] = e < dg ? e_src[lo + e] : 0;
    lp[e] = e < dg ? e_lp[lo + e] : -INFINITY;
  }
  *src_out = make_int2(sv[0] | (sv[1] << 16), sv[2] | (sv[3] << 16));
  *lp_out = make_float4(lp[0], lp[1], lp[2], lp[3]);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
viterbi_kernel(const int8_t* __restrict__ tokens, int L, int B,
               const int32_t* __restrict__ lens,
               const int32_t* __restrict__ ends,
               const int32_t* __restrict__ u_map,
               const int32_t* __restrict__ e_off_all,
               const int16_t* __restrict__ e_src_all,
               const float* __restrict__ e_lp_all, int E,
               const float* __restrict__ em_all,
               const uint8_t* __restrict__ silent_all,
               const uint8_t* __restrict__ has_edges_all,
               const uint8_t* __restrict__ seed_all,
               const int16_t* __restrict__ sched_all,
               const int16_t* __restrict__ sl_link_all,
               const int16_t* __restrict__ sl_edge_all,
               const int16_t* __restrict__ ph_off_all,
               const int16_t* __restrict__ ph_depth_all, int NS, int P,
               int S, int K, int chunk, int per_warp,
               uint16_t* __restrict__ pv, int16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // no block barrier below
  const Slice s = carve(smem + static_cast<size_t>(warp) * per_warp, S, NS,
                        P, chunk);
  const int u = u_map[b];
  const int len = lens[b];
  const int Sp = round8(S);
  const int32_t* e_off = e_off_all + static_cast<size_t>(u) * (S + 1);
  const int16_t* e_src = e_src_all + static_cast<size_t>(u) * E;
  const float* e_lp = e_lp_all + static_cast<size_t>(u) * E;

  // prologue: copy the topology's tables into the slice
  for (int d = lane; d < S; d += 32) {
    const int lo = e_off[d];
    const int dg = e_off[d + 1] - lo;
    pack_edges(e_src, e_lp, lo, dg, &s.ell_src[d], &s.ell_lp[d]);
    const size_t at = static_cast<size_t>(u) * S + d;
    s.flags[d] = (silent_all[at] ? kSilent : 0) |
                 (has_edges_all[at] ? kHasEdges : 0) |
                 (seed_all[at] ? kSeed : 0) | (dg > kEll ? kTail : 0);
  }
  for (int i = lane; i < 5 * S; i += 32)
    s.em[i] = em_all[static_cast<size_t>(u) * 5 * S + i];
  for (int i = lane; i <= P; i += 32)
    s.ph_off[i] = ph_off_all[static_cast<size_t>(u) * (P + 1) + i];
  for (int i = lane; i < P; i += 32)
    s.ph_depth[i] = ph_depth_all[static_cast<size_t>(u) * P + i];
  const int n_slots = ph_off_all[static_cast<size_t>(u) * (P + 1) + P];
  for (int i = lane; i < n_slots; i += 32) {
    const int d = sched_all[static_cast<size_t>(u) * NS + i];
    const int link = sl_link_all[static_cast<size_t>(u) * NS + i];
    const int lo = e_off[d];
    const int dg = e_off[d + 1] - lo;
    pack_edges(e_src, e_lp, lo, dg, &s.sl_src[i], &s.sl_lp[i]);
    s.sl_meta[i] = make_int2(
        d | (dg > kEll ? kSlotTail : 0) | ((link >> 6) << kSlotStepShift) |
            ((link & 63) << kSlotLaneShift),
        sl_edge_all[static_cast<size_t>(u) * NS + i]);
  }
  // rows past len are never walked: segments -1
  for (size_t i = lane; i < static_cast<size_t>(L - len) * K; i += 32) {
    const size_t t = len + i / K;
    out[(t * B + b) * K + i % K] = -1;
  }
  __syncwarp();

  // A lane's first state of step 1 stays in registers for the whole row
  // (measured: 120 ns a position less than reloading it; keeping the
  // phases' states in registers as well gained nothing).
  const int f_first = lane < S ? s.flags[lane] : 0;
  const Edges ed_first =
      lane < S ? unpack(s.ell_src[lane], s.ell_lp[lane]) : Edges{};

  const int8_t* tok = tokens + static_cast<size_t>(b) * L;
  uint16_t* pv_row = pv + static_cast<size_t>(b) * L * Sp;
  float* col = s.col0;
  float* nxt = s.col1;
  bool prev_any = false;
  int tok_cur = 0;
  int tok_next = lane < len ? tok[lane] : 0;
  for (int t = 0; t < len; ++t) {
    if ((t & 31) == 0) {
      tok_cur = tok_next;
      tok_next = t + 32 + lane < len ? tok[t + 32 + lane] : 0;
    }
    const int sym = __shfl_sync(kFull, tok_cur, t & 31);

    // 1. every state over the previous column
    bool lane_ok = false;
    const auto candidates = [&](int d, int f, const Edges& ed) {
      float c[kEll];
#pragma unroll
      for (int e = 0; e < kEll; ++e) c[e] = col[ed.src[e]] + ed.lp[e];
      Best bb{c[0], ed.src[0]};
#pragma unroll
      for (int e = 1; e < kEll; ++e) best_add(bb, c[e], ed.src[e]);
      if (f & kTail) {
        const int lo = e_off[d];
        const int dg = e_off[d + 1] - lo;
        for (int e = kEll; e < dg; ++e) {
          const int src = e_src[lo + e];
          best_add(bb, col[src] + e_lp[lo + e], src);
        }
      }
      if (bb.v < kDeepNeg && prev_any) bb.p = 0;
      return bb;
    };
    const auto settle = [&](int d, int f, float em, Best bb) {
      float v;
      bool ok;
      if (t == 0) {
        // only edge-less emitting states seed
        const bool seed = (f & kSeed) != 0;
        v = seed ? em : kNeg;
        bb.p = d;
        ok = seed && v > kHalfNeg;
      } else {
        const bool sil = (f & kSilent) != 0;
        const float cand = sil ? kNeg : bb.v + em;
        ok = !sil && (f & kHasEdges) != 0 && cand > kHalfNeg;
        v = ok ? cand : kNeg;
      }
      nxt[d] = v;
      s.word[d] = static_cast<uint16_t>(
          bb.p | ((f & kSilent) ? kWordSilent : 0) | (ok ? kWordValid : 0));
      lane_ok = lane_ok || ok;
    };
    if (lane < S)
      settle(lane, f_first, s.em[lane * 5 + sym],
             candidates(lane, f_first, ed_first));
    for (int d = lane + 32; d < S; d += 32) {
      const int f = s.flags[d];
      const float em = s.em[d * 5 + sym];
      settle(d, f, em, candidates(d, f, unpack(s.ell_src[d], s.ell_lp[d])));
    }
    const bool cur_any = __any_sync(kFull, lane_ok);
    __syncwarp();

    // 2. the silent states, phase by phase, a lane each
    for (int ph = 0; ph < P; ++ph) {
      // the lane's state in this phase; a lane without one keeps edges
      // of -inf and no step, and settles nothing
      const int base = s.ph_off[ph];
      const int depth = s.ph_depth[ph];
      Edges ed{{0, 0, 0, 0},
               {-INFINITY, -INFINITY, -INFINITY, -INFINITY}};
      int d = 0, step = -1, chain_lane = 0, chain_edge = -1;
      bool tail = false;
      if (lane < s.ph_off[ph + 1] - base) {
        const int2 meta = s.sl_meta[base + lane];
        ed = unpack(s.sl_src[base + lane], s.sl_lp[base + lane]);
        d = meta.x & kWordPred;
        step = (meta.x >> kSlotStepShift) & 0xFF;
        chain_lane = (meta.x >> kSlotLaneShift) - 1;
        chain_edge = meta.y;
        tail = (meta.x & kSlotTail) != 0;
      }
      // over the final sources: the first max before the chain edge in
      // rank order, and the first max after it (every edge counts as
      // after when there is no chain edge). Branch-free: an edge on the
      // wrong side enters as -inf, which never wins.
      Best pre{-INFINITY, 0}, post{-INFINITY, 0};
      float chain_lp = -INFINITY;  // no chain edge: its candidate is -inf
      int chain_src = 0;
      float c[kEll];
#pragma unroll
      for (int e = 0; e < kEll; ++e) c[e] = nxt[ed.src[e]] + ed.lp[e];
#pragma unroll
      for (int e = 0; e < kEll; ++e) {
        best_add(pre, e < chain_edge ? c[e] : -INFINITY, ed.src[e]);
        best_add(post, e > chain_edge ? c[e] : -INFINITY, ed.src[e]);
        chain_lp = e == chain_edge ? ed.lp[e] : chain_lp;
        chain_src = e == chain_edge ? ed.src[e] : chain_src;
      }
      if (tail) {
        const int lo = e_off[d];
        const int dg = e_off[d + 1] - lo;
        for (int e = kEll; e < dg; ++e) {
          const int src = e_src[lo + e];
          const float lp = e_lp[lo + e];
          const float ce = nxt[src] + lp;
          best_add(pre, e < chain_edge ? ce : -INFINITY, src);
          best_add(post, e > chain_edge ? ce : -INFINITY, src);
          chain_lp = e == chain_edge ? lp : chain_lp;
          chain_src = e == chain_edge ? src : chain_src;
        }
      }
      // without the chain edge the first max is `pre` unless `post` is
      // strictly larger
      const Best around = post.v > pre.v ? post : pre;
      // The chain values, a step at a time; x is a settled state's value
      // in the column: the max of its candidates, or NEG if that is not
      // valid (then it is NEG, 2*NEG or -inf, all at most NEG). Only the
      // value travels; which edge won is settled after the loop from the
      // chain candidate the lane saw at its own step.
      const float floor = fmaxf(around.v, kNeg);
      float x = kNeg;
      float cand = -INFINITY;
      for (int st = 0; st < depth; ++st) {
        const float c_st =
            __shfl_sync(kFull, x, chain_lane & 31) + chain_lp;
        const bool now = step == st;
        x = now ? fmaxf(c_st, floor) : x;
        cand = now ? c_st : cand;
      }
      // rank order: pre, chain edge, post, each winning only if larger
      Best bb = around;
      if (cand > pre.v) {
        bb.v = post.v > cand ? post.v : cand;
        bb.p = post.v > cand ? post.p : chain_src;
      }
      if (bb.v < kDeepNeg && cur_any) bb.p = 0;
      if (bb.v > kHalfNeg) {
        // an invalid state keeps NEG and the word of step 1
        nxt[d] = bb.v;
        s.word[d] =
            static_cast<uint16_t>(bb.p | kWordSilent | kWordValid);
      }
      __syncwarp();
    }

    // 3. the position's words, a lane's states 64 bytes apart
    uint16_t* pv_t = pv_row + static_cast<size_t>(t) * Sp;
    for (int d = lane; d < S; d += 32) pv_t[d] = s.word[d];
    float* tmp = col;
    col = nxt;
    nxt = tmp;
    prev_any = cur_any;
  }
  __syncwarp();

  // back_step: arm at (len-1, end state); each column walks its silent
  // chain (at most K states) down to the emitting state, whose
  // predecessor enters column t-1. The positions come in chunks, from the
  // last chunk to the first; a chunk's words are copied into one half of
  // `stage` while the chunk after it is walked in the other half.
  bool ok = true;
  int cur = ends[b];
  const int n_chunks = (len + chunk - 1) / chunk;
  const auto fetch = [&](int c) {
    const int first = c * chunk;
    const int n_vec = (min(len, first + chunk) - first) * (Sp / 8);
    const uint16_t* src = pv_row + static_cast<size_t>(first) * Sp;
    uint16_t* dst = s.stage + (c & 1) * chunk * Sp;
    for (int x = lane; x < n_vec; x += 32)
      __pipeline_memcpy_async(dst + 8 * x, src + 8 * x, 16);
  };
  if (n_chunks > 0) fetch(n_chunks - 1);
  __pipeline_commit();
  for (int c = n_chunks - 1; c >= 0; --c) {
    if (c > 0) fetch(c - 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncwarp();
    const int first = c * chunk;
    for (int t = min(len, first + chunk) - 1; t >= first; --t) {
      const uint16_t* words = s.stage + ((c & 1) * chunk + t - first) * Sp;
      int16_t* seg = out + (static_cast<size_t>(t) * B + b) * K;
      int st = cur;
      int next = cur;
      bool alive = true;
      int k = 0;
      for (int k0 = 0; k0 < K; k0 += 32) {
        // lane l keeps entry k0 + l; entries past the chain's end are -1
        int mine = -1;
        const int k_end = min(K, k0 + 32);
        for (; alive && k < k_end; ++k) {
          const int w = words[st];
          if (lane == (k & 31)) mine = st;
          ok = ok && (w & kWordValid) != 0;
          if (w & kWordSilent) {
            st = w & kWordPred;
          } else {
            next = w & kWordPred;
            alive = false;
          }
        }
        if (k0 + lane < K) seg[k0 + lane] = static_cast<int16_t>(mine);
      }
      // a silent chain longer than K would keep a stale state
      ok = ok && !alive;
      cur = next;
    }
    // the half just walked is the target of the copy after next
    __syncwarp();
  }
  int16_t* ok_row = out + (static_cast<size_t>(L) * B + b) * K;
  for (int k = lane; k < K; k += 32) ok_row[k] = ok ? 1 : 0;
}

}  // namespace

// tokens: (B, L) int8 symbols; lens, ends, u_map: (B,). Per topology u:
// e_off (U, S+1), e_src and e_lp (U, E): CSR of in-edges in rank order;
// em: (U, S, 5); silent, has_edges, no_edge_emit: (U, S) bytes; sched,
// sl_link, sl_edge (U, NS), ph_off (U, P+1), ph_depth (U, max(P, 1)): the
// silent schedule of P phases (viterbi_tables.py). K = silent levels + 1.
// pv: (B, L, round8(S)) uint16 scratch; out: (L+1, B, K) segments + ok
// row. `warps` rows share a block, each with `per_warp` bytes of dynamic
// shared memory (at least trgt_viterbi_slice_bytes for the traceback's
// `chunk` positions). Returns the launch's cudaGetLastError().
extern "C" int trgt_viterbi_slice_bytes(int S, int NS, int P, int chunk) {
  return static_cast<int>(slice_bytes(S, NS, P, chunk));
}

extern "C" int trgt_viterbi(const int8_t* tokens, int L, int B,
                            const int32_t* lens, const int32_t* ends,
                            const int32_t* u_map, const int32_t* e_off,
                            const int16_t* e_src, const float* e_lp, int E,
                            const float* em, const uint8_t* silent,
                            const uint8_t* has_edges,
                            const uint8_t* no_edge_emit,
                            const int16_t* sched, const int16_t* sl_link,
                            const int16_t* sl_edge, const int16_t* ph_off,
                            const int16_t* ph_depth, int NS, int P, int S,
                            int K, int chunk, int warps, int per_warp,
                            void* pv, int16_t* out, void* stream) {
  if (B <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps || chunk < 1 || S > kWordPred ||
      static_cast<size_t>(per_warp) < slice_bytes(S, NS, P, chunk) ||
      per_warp % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem_bytes = warps * per_warp;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  viterbi_kernel<<<(B + warps - 1) / warps, 32 * warps, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      tokens, L, B, lens, ends, u_map, e_off, e_src, e_lp, E, em, silent,
      has_edges, no_edge_emit, sched, sl_link, sl_edge, ph_off, ph_depth,
      NS, P, S, K, chunk, per_warp, static_cast<uint16_t*>(pv), out);
  return static_cast<int>(cudaGetLastError());
}
