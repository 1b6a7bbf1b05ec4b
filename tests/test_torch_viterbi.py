"""The port's Viterbi (trgt_tpu_torch/kernels/viterbi.py) held exactly
against the JAX device function `viterbi_batch_multi` / `_viterbi_full`
on the CPU and against the host twin `Hmm.label`; the port's numpy tables
against `_stack_tables`. Every comparison is exact: state paths and
segment arrays as integers, tables array by array.

The sparse tables the CUDA kernel reads (in-edge CSR, silent schedule) are
held here on the CPU: against the dense tables edge for edge, and through
a numpy twin of the kernel's position step (`kernel_relax`, `KernelTwin`)
against the dense relax and against `viterbi_plain`, for every state,
valid or not, and for rows with no valid path. Nothing is narrowed: the
twin's words and segments equal the dense ones everywhere."""

import random

import numpy as np
import pytest
import torch

from trgt_tpu.hmm import build_hmm
from trgt_tpu_torch.kernels import viterbi as vt
from trgt_tpu_torch.kernels import telemetry
from trgt_tpu_torch.kernels import viterbi_tables as tables

CPU = torch.device("cpu")
# the plain versions issue many tiny ops: with several test workers on
# one machine, more than one intra-op thread each oversubscribes the cores
torch.set_num_threads(1)
# trgt_tpu.kernels.viterbi (JAX) is imported inside the tests that compare
# with it, so the `cuda` test of this file also runs where JAX is not
# installed: python -m pytest --noconftest tests/test_torch_*.py -m cuda


def random_repeat(rng, motifs, n_copies, error_rate=0.0):
    seq = []
    for _ in range(n_copies):
        for c in rng.choice(motifs).decode():
            r = rng.random()
            if r < error_rate / 3:
                continue
            seq.append(rng.choice("ACGT") if r < 2 * error_rate / 3 else c)
            if rng.random() < error_rate / 3:
                seq.append(rng.choice("ACGT"))
    return "".join(seq)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("motifs", [[b"CAG"], [b"CAG", b"A"],
                                    [b"AAG", b"CAAC"]])
def test_plain_matches_jax_and_host(motifs):
    from trgt_tpu.kernels import viterbi as jax_viterbi
    rng = random.Random(42)
    hmm = build_hmm(motifs)
    queries = [random_repeat(rng, motifs, rng.randint(3, 15), 0.1)
               for _ in range(12)] + ["", "TTTTTTTT"]
    got = vt.viterbi_batch_multi([hmm] * len(queries), queries, CPU)
    assert got == jax_viterbi.viterbi_batch_multi([hmm] * len(queries),
                                                  queries)
    assert got == [hmm.label(q) for q in queries]


@pytest.mark.parametrize("error_rate", [0.05, 0.15, 0.25])
@pytest.mark.parametrize("motifs", [[b"CAG"], [b"CAG", b"A"],
                                    [b"AAGGC", b"TTA"]],
                         ids=lambda m: ",".join(x.decode() for x in m))
def test_plain_matches_jax_on_noisy_queries(motifs, error_rate):
    """ROADMAP C4: on noisy queries the float32 path (the port's plain
    version and CUDA kernel, and trgt_tpu's `viterbi_batch_multi`) and the
    float64 host twin `Hmm.label` pick different paths for some queries.
    The port follows trgt_tpu's device path exactly; the count that
    differs from `Hmm.label` is printed (ROADMAP records it), not held."""
    from trgt_tpu.kernels import viterbi as jax_viterbi
    rng = random.Random(1)
    hmm = build_hmm(motifs)
    queries = [random_repeat(rng, motifs, rng.randint(10, 120), error_rate)
               for _ in range(150)]
    got = vt.viterbi_batch_multi([hmm] * len(queries), queries, CPU)
    assert got == jax_viterbi.viterbi_batch_multi([hmm] * len(queries),
                                                  queries)
    n_host = sum(g != hmm.label(q) for g, q in zip(got, queries))
    print(f"C4 {b','.join(motifs).decode()} at {error_rate:.0%} errors: "
          f"{n_host} of {len(queries)} paths differ from Hmm.label")


def test_heterogeneous_hmms_in_one_batch():
    from trgt_tpu.kernels import viterbi as jax_viterbi
    hmms = [build_hmm(m) for m in ([b"CAG"], [b"CAG", b"A"],
                                   [b"AAG", b"CAAC"], [b"A"])]
    queries = ["CAGCAGCAG", "CAGCAGAAA", "AAGAAGCAACAAG", "AAAAAA"]
    got = vt.viterbi_batch_multi(hmms, queries, CPU)
    assert got == jax_viterbi.viterbi_batch_multi(hmms, queries)
    assert got == [h.label(q) for h, q in zip(hmms, queries)]


def test_mixed_lengths_and_topologies():
    from trgt_tpu.kernels import viterbi as jax_viterbi
    rng = random.Random(5)
    motif_sets = [[b"CAG"], [b"CAG", b"A"], [b"AAGGC", b"TTA"]]
    hmms, queries = [], []
    for n_copies in (2, 3, 40, 3, 200, 7, 2, 90):
        ms = rng.choice(motif_sets)
        hmms.append(build_hmm(ms))
        queries.append(random_repeat(rng, ms, n_copies, 0.02))
    queries[3] = ""
    got = vt.viterbi_batch_multi(hmms, queries, CPU)
    assert got == jax_viterbi.viterbi_batch_multi(hmms, queries)
    assert got == [h.label(q) if q else [] for h, q in zip(hmms, queries)]


def test_plain_segments_equal_viterbi_full():
    """The raw (L+1, B, K) segment array, not only the assembled paths."""
    from trgt_tpu.kernels import viterbi as jax_viterbi
    rng = random.Random(9)
    motif_sets = [[b"CAG"], [b"AAG", b"CAAC"], [b"T", b"GATA"]]
    hmm_of = {tuple(m): build_hmm(m) for m in motif_sets}
    hmms, queries = [], []
    for i in range(9):
        ms = motif_sets[i % 3]
        hmms.append(hmm_of[tuple(ms)])
        queries.append(random_repeat(rng, ms, rng.randint(2, 12), 0.1))
    args = vt.prepare_batch(hmms, queries, CPU)
    got = vt.viterbi_plain(*args).numpy()
    toks, lens = jax_viterbi.encode_queries(queries, pad_batch=len(queries))
    B = toks.shape[0]
    padded = hmms + [hmms[0]] * (B - len(hmms))
    jt, n_levels = jax_viterbi._stack_tables(padded)
    lens_full = np.zeros(B, dtype=np.int32)
    lens_full[:len(queries)] = lens
    ends = np.array([h.num_states - 1 for h in padded], dtype=np.int32)
    want = np.asarray(jax_viterbi._viterbi_full(
        toks, jt, lens_full, ends, n_levels))
    assert n_levels == args[4]
    np.testing.assert_array_equal(got[:-1], want[:-1, :len(queries)])
    np.testing.assert_array_equal(got[-1], want[-1, :len(queries)])


def test_tables_equal_jax_stack_tables():
    from trgt_tpu.kernels import viterbi as jax_viterbi
    hmms = [build_hmm(m) for m in ([b"CAG"], [b"CAG", b"A"],
                                   [b"AATGG", b"CCATTTTAGG"], [b"T"])]
    hmms.append(hmms[1])                      # deduplicated by instance
    got, n_got = tables.stack_tables(hmms)
    want, n_want = jax_viterbi._stack_tables(hmms)
    assert n_got == n_want
    assert set(got) == set(want)
    for k in want:
        w = want[k]
        if k == "R":
            # widened: uint8 with 255 = absent → int16 with NO_RANK
            w = np.where(w == 255, tables.NO_RANK, w.astype(np.int16))
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_encode_queries_equal_jax():
    from trgt_tpu.kernels import viterbi as jax_viterbi
    queries = ["CAG" * 5, "A", "ACGTTGCA" * 30]
    toks, lens = tables.encode_queries(queries)
    j_toks, j_lens = jax_viterbi.encode_queries(queries,
                                                pad_batch=len(queries))
    np.testing.assert_array_equal(lens, j_lens)
    np.testing.assert_array_equal(toks, j_toks[:len(queries)])


def test_tables_to_torch_keeps_arrays():
    t_np, _ = tables.stack_tables([build_hmm([b"CAG", b"A"])])
    t = tables.tables_to_torch(t_np, CPU)
    for k, v in t_np.items():
        np.testing.assert_array_equal(t[k].numpy(), v)


def test_wrapper_rejects_other_devices():
    hmm = build_hmm([b"CAG"])
    args = vt.prepare_batch([hmm], ["CAGCAG"], torch.device("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        vt.viterbi_segs(*args)


def fuzz_motifs(seed):
    rng = random.Random(seed)
    return [bytes(rng.choice(b"ACGT") for _ in range(rng.randint(1, 10)))
            for _ in range(rng.randint(1, 3))]


def odd_hmm():
    """[CAG, A] with the first delete state of CAG given a duplicate edge
    and a zero-probability edge, and the second one only zero-probability
    edges (states: motif start 2, match 3-5, insert 6-8, delete 9-10)."""
    hmm = build_hmm([b"CAG", b"A"])
    hmm.set_trans(9, [3, 4, 3], [0.05, 0.0, 0.2])
    hmm.set_trans(10, [4, 9], [0.0, 0.0])
    return hmm


def topologies():
    return ([build_hmm(fuzz_motifs(seed)) for seed in range(8)]
            + [build_hmm([b"A"]), build_hmm([b"T", b"GATA", b"CCATAGG"]),
               odd_hmm()])


TOPOLOGIES = list(range(11))


@pytest.mark.parametrize("which", TOPOLOGIES)
def test_sparse_tables_reproduce_dense(which):
    hmm = topologies()[which]
    dense = tables.hmm_dense_numpy(hmm)
    sp = tables.hmm_sparse_numpy(hmm)
    S = hmm.num_states
    T = np.full((S, S), tables.NEG, dtype=np.float32)
    R = np.full((S, S), tables.NO_RANK, dtype=np.int16)
    assert sp["e_off"][0] == 0 and sp["e_off"][-1] == len(sp["e_src"])
    for d in range(S):
        lo, hi = sp["e_off"][d], sp["e_off"][d + 1]
        ranks = sp["e_rank"][lo:hi]
        assert list(ranks) == sorted(set(ranks.tolist()))   # rank-sorted
        assert len(set(sp["e_src"][lo:hi].tolist())) == hi - lo
        T[d, sp["e_src"][lo:hi]] = sp["e_lp"][lo:hi]
        R[d, sp["e_src"][lo:hi]] = ranks
    np.testing.assert_array_equal(T, dense["T"])
    np.testing.assert_array_equal(R, dense["R"])
    # the silent states in level order
    levels = hmm.silent_levels()
    assert sp["num_levels"] == len(levels)
    for li, level in enumerate(levels):
        lo, hi = sp["lv_off"][li], sp["lv_off"][li + 1]
        assert sp["lv_states"][lo:hi].tolist() == level
    # the schedule: every silent state once, at most a warp's lanes per
    # phase; a silent source lies in an earlier phase, or is the state's
    # one chain source, in the same phase one step earlier
    assert sorted(sp["sched"].tolist()) == sorted(
        s for level in levels for s in level)
    silent = set(sp["sched"].tolist())
    where = {}
    for ph in range(len(sp["ph_depth"])):
        lo, hi = sp["ph_off"][ph], sp["ph_off"][ph + 1]
        assert 0 < hi - lo <= tables.LANES
        steps = []
        for i in range(lo, hi):
            link = int(sp["sl_link"][i])
            where[int(sp["sched"][i])] = (ph, i - lo, link >> 6)
            steps.append(link >> 6)
        assert sp["ph_depth"][ph] == max(steps) + 1
    for i, d in enumerate(sp["sched"].tolist()):
        ph, lane, step = where[d]
        chain_lane = (int(sp["sl_link"][i]) & 63) - 1
        edges = sp["e_src"][sp["e_off"][d]:sp["e_off"][d + 1]].tolist()
        chain = -1
        if chain_lane >= 0:
            chain = int(sp["sched"][sp["ph_off"][ph] + chain_lane])
            assert edges[sp["sl_edge"][i]] == chain
            assert where[chain] == (ph, chain_lane, step - 1)
        else:
            assert sp["sl_edge"][i] == -1 and step == 0
        for src in hmm.in_states[d]:
            if src in silent and src != chain:
                assert where[src][0] < ph, (d, src)


def test_delete_chain_shares_a_phase():
    # what the schedule is for: CCATAGG's six delete states and its motif
    # end are a chain of phase 0, a step each; run end, run start and the
    # motif starts are phase 1
    hmm = build_hmm([b"CCATAGG"])
    sp = tables.hmm_sparse_numpy(hmm)
    first_del = 2 + 1 + 7 + 7
    chain = list(range(first_del, first_del + 6)) + [2 + 3 * 7]
    step = {int(d): int(l) >> 6
            for d, l in zip(sp["sched"], sp["sl_link"])}
    lo, hi = sp["ph_off"][0], sp["ph_off"][1]
    assert set(chain) <= set(sp["sched"][lo:hi].tolist())
    assert [step[d] for d in chain] == list(range(7))
    assert sp["ph_depth"].tolist() == [7, 3]


def test_long_chain_spills_into_the_next_phase():
    # 39 delete states do not fit a phase of 32 lanes: the chain goes on
    # in the next phase, over a source that is final by then
    sp = tables.hmm_sparse_numpy(build_hmm([b"ACGT" * 10]))
    counts = np.diff(sp["ph_off"]).tolist()
    assert counts[0] == tables.LANES and len(counts) == 3


def dense_relax(col, T, R):
    """`viterbi_plain`'s relax for one row: (best, pred) per state."""
    S = len(col)
    src = np.arange(S)
    cand = (col[None, :] + T).astype(np.float32)
    best = cand.max(axis=1)
    tie = cand >= best[:, None]
    key = np.where(tie, R.astype(np.int64) * S + src,
                   tables.NO_RANK * S + src)
    return best, key.argmin(axis=1)


def kernel_relax(sp, d, col, any_valid):
    """csrc/viterbi.cu's relax of state d: first max over its in-edge list,
    fp32; state 0 when the max is 2*NEG and some state of the column is
    valid, or when the list is empty."""
    best, pred = np.float32(-np.inf), 0
    for e in range(sp["e_off"][d], sp["e_off"][d + 1]):
        c = np.float32(col[sp["e_src"][e]] + sp["e_lp"][e])
        if c > best:
            best, pred = c, int(sp["e_src"][e])
    if best < np.float32(-1.5e30) and any_valid:
        pred = 0
    return best, pred


@pytest.mark.parametrize("which", TOPOLOGIES)
def test_sparse_relax_equals_dense_relax(which):
    hmm = topologies()[which]
    dense = tables.hmm_dense_numpy(hmm)
    sp = tables.hmm_sparse_numpy(hmm)
    S = hmm.num_states
    rng = np.random.default_rng(which)
    neg = np.float32(tables.NEG)
    for trial in range(40):
        # few distinct values, so sources tie; any share of invalid states
        col = -np.float32(0.5) * rng.integers(0, 6, S).astype(np.float32)
        col[rng.random(S) < (trial % 5) / 4] = neg
        best, pred = dense_relax(col, dense["T"], dense["R"])
        any_valid = bool((col > neg / 2).any())
        for d in range(S):
            k_best, k_pred = kernel_relax(sp, d, col, any_valid)
            assert k_pred == pred[d], (trial, d)
            # a valid maximum is the dense one; an invalid one is dropped
            if best[d] > neg / 2:
                assert k_best == best[d]
            else:
                assert not k_best > neg / 2


class KernelTwin:
    """csrc/viterbi.cu in numpy for one row: the position loop over the
    sparse tables and the schedule, then the traceback."""

    def __init__(self, hmm):
        self.sp = tables.hmm_sparse_numpy(hmm)
        self.S = hmm.num_states
        silent = self.sp["silent"]
        self.silent = silent
        self.has_edges = self.sp["has_edges"]
        self.seed = ~self.has_edges & ~silent

    def forward(self, toks):
        sp, S = self.sp, self.S
        neg = np.float32(tables.NEG)
        col = np.full(S, neg, dtype=np.float32)
        prev_any = False
        words = []
        for t, sym in enumerate(toks):
            nxt = np.full(S, neg, dtype=np.float32)
            pred = np.zeros(S, dtype=np.int64)
            valid = np.zeros(S, dtype=bool)
            for d in range(S):
                if t == 0:
                    v = sp["em"][d, sym] if self.seed[d] else neg
                    pred[d] = d
                    valid[d] = self.seed[d] and v > neg / 2
                else:
                    best, pred[d] = kernel_relax(sp, d, col, prev_any)
                    c = neg if self.silent[d] else \
                        np.float32(best + sp["em"][d, sym])
                    valid[d] = (not self.silent[d] and self.has_edges[d]
                                and c > neg / 2)
                    v = c if valid[d] else neg
                nxt[d] = v
            cur_any = bool(valid.any())
            for ph in range(len(sp["ph_depth"])):
                # the lanes relax side by side over the column as the
                # phase found it; only a chain source's new value travels
                lo, hi = sp["ph_off"][ph], sp["ph_off"][ph + 1]
                found = nxt.copy()
                settled = {}
                for step in range(sp["ph_depth"][ph]):
                    for i in range(lo, hi):
                        link = int(sp["sl_link"][i])
                        if link >> 6 != step:
                            continue
                        d = int(sp["sched"][i])
                        mine = found.copy()
                        if link & 63:
                            chain = int(sp["sched"][lo + (link & 63) - 1])
                            mine[chain] = settled[chain]
                        best, p = kernel_relax(sp, d, mine, cur_any)
                        settled[d] = best if best > neg / 2 else neg
                        if best > neg / 2:
                            nxt[d], pred[d], valid[d] = best, p, True
            words.append((pred, valid))
            col, prev_any = nxt, cur_any
        return words

    def segments(self, toks, end, K, L):
        words = self.forward(toks)
        segs = np.full((L + 1, K), -1, dtype=np.int16)
        ok, cur = True, end
        for t in range(len(toks) - 1, -1, -1):
            pred, valid = words[t]
            s, nxt_cur, alive = cur, cur, True
            for k in range(K):
                if not alive:
                    continue
                segs[t, k] = s
                ok = ok and bool(valid[s])
                if self.silent[s]:
                    s = int(pred[s])
                else:
                    nxt_cur, alive = int(pred[s]), False
            ok = ok and not alive
            cur = nxt_cur
        segs[L] = 1 if ok else 0
        return segs


@pytest.mark.parametrize("which", TOPOLOGIES)
def test_kernel_twin_equals_plain(which):
    """Whole rows through the kernel's arithmetic: equal to `viterbi_plain`
    in every segment, for rows with a valid path and rows without one."""
    hmm = topologies()[which]
    rng = np.random.default_rng(100 + which)
    S = hmm.num_states
    L = 48
    rows = []
    for b in range(6):
        n = int(rng.integers(2, L + 1))
        toks = rng.integers(1, 5, n)
        if b % 2 == 0:
            toks[0] = toks[-1] = 0            # '#' at both ends: a path
        if b == 5:
            toks[n // 2] = 0                  # '#' inside: no valid path
        rows.append(toks)
    tokens = np.zeros((len(rows), L), dtype=np.int8)
    for b, toks in enumerate(rows):
        tokens[b, :len(toks)] = toks
    lens = np.array([len(r) for r in rows], dtype=np.int32)
    ends = np.full(len(rows), S - 1, dtype=np.int32)
    t_np, n_levels = tables.stack_tables([hmm] * len(rows))
    want = vt.viterbi_plain(
        torch.from_numpy(tokens), tables.tables_to_torch(t_np, CPU),
        torch.from_numpy(lens), torch.from_numpy(ends), n_levels).numpy()
    twin = KernelTwin(hmm)
    oks = []
    for b, toks in enumerate(rows):
        got = twin.segments(toks, S - 1, n_levels + 1, L)
        np.testing.assert_array_equal(got, want[:, b], err_msg=str(b))
        oks.append(int(got[L, 0]))
    assert 0 in oks                           # rows with no valid path


def test_stacked_sparse_tables_equal_stacked_dense():
    """A batch's stacked sparse tables name the same edges, values and
    order of ranks as its stacked dense ones, topology by topology, and
    share every other array with them."""
    hmms = [build_hmm(m) for m in ([b"CAG"], [b"AATGG", b"CCATTTTAGG"],
                                   [b"T"])] + [odd_hmm()]
    hmms.append(hmms[1])
    d_np, n_levels = tables.stack_tables(hmms)
    s_np, n_sparse = tables.stack_sparse_tables(hmms)
    assert n_levels == n_sparse
    U, S = s_np["e_off"].shape[0], s_np["e_off"].shape[1] - 1
    assert d_np["T"].shape == (U, S, S)
    T = np.full((U, S, S), tables.NEG, dtype=np.float32)
    place = np.full((U, S, S), tables.NO_RANK, dtype=np.int16)
    for u in range(U):
        for d in range(S):
            lo, hi = s_np["e_off"][u, d], s_np["e_off"][u, d + 1]
            T[u, d, s_np["e_src"][u, lo:hi]] = s_np["e_lp"][u, lo:hi]
            place[u, d, s_np["e_src"][u, lo:hi]] = np.arange(hi - lo)
    np.testing.assert_array_equal(T, d_np["T"])
    np.testing.assert_array_equal(place < tables.NO_RANK,
                                  d_np["R"] < tables.NO_RANK)
    np.testing.assert_array_equal(np.argsort(place, axis=2, kind="stable"),
                                  np.argsort(d_np["R"], axis=2,
                                             kind="stable"))
    for k in ("em", "silent", "has_edges", "no_edge_emit", "u_map"):
        np.testing.assert_array_equal(s_np[k], d_np[k], err_msg=k)
    # only what the kernel reads is stacked, and so uploaded
    assert set(s_np) == {"e_off", "e_src", "e_lp", "sched", "sl_link",
                         "sl_edge", "ph_off", "ph_depth", "em", "silent",
                         "has_edges", "no_edge_emit", "u_map"}


def test_cuda_batches_get_sparse_tables():
    hmm = build_hmm([b"CAG"])
    args = vt.prepare_batch([hmm], ["CAGCAG"], torch.device("meta"))
    assert "T" in args[1] and "e_off" not in args[1]
    s_np, _ = tables.stack_sparse_tables([hmm])
    assert "T" not in s_np and "R" not in s_np
    with pytest.raises(ValueError, match="sparse tables"):
        vt._viterbi_cuda(*vt.prepare_batch([hmm], ["CAGCAG"], CPU))
    # the plain version takes the dense tables only, on any device
    sparse = vt.prepare_batch([hmm], ["CAGCAG"], CPU, sparse=True)
    assert "e_off" in sparse[1] and "T" not in sparse[1]
    with pytest.raises(KeyError):
        vt.viterbi_plain(*sparse)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    rng = random.Random(3)
    motif_sets = [[b"CAG"], [b"CAG", b"A"], [b"AATGG", b"CCATTTTAGG"]]
    launches = telemetry.count("viterbi")
    for ms in motif_sets:
        hmm = build_hmm(ms)
        queries = [random_repeat(rng, ms, n, 0.05) for n in (3, 30, 300)]
        args = vt.prepare_batch([hmm] * 3, queries, cuda_device)
        got = vt.viterbi_segs(*args).cpu().numpy()
        # the plain version on dense tables built from the edge lists
        want = vt.viterbi_plain(*vt.prepare_batch(
            [hmm] * 3, queries, cuda_device, sparse=False)).cpu().numpy()
        np.testing.assert_array_equal(got, want)
    assert telemetry.count("viterbi") > launches


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_mixed_topologies(cuda_device):
    """Every topology of this file in one batch (state counts on both
    sides of 32 and 64, up to three motifs, duplicate and zero-probability
    edges), rows with no valid path included: segments equal everywhere."""
    rng = random.Random(17)
    hmms = topologies() + [build_hmm([b"A", b"CG", b"TTA", b"GGCA", b"CCTGA"]),
                           build_hmm([b"ACGT" * 10])]
    queries = []
    for i, hmm in enumerate(hmms):
        q = "".join(rng.choice("ACGT") for _ in range(rng.randint(5, 200)))
        queries.append(q[:len(q) // 2] + "N" + q[len(q) // 2:]
                       if i % 3 == 0 else q)
    args = vt.prepare_batch(hmms, queries, cuda_device)
    assert "e_off" in args[1]
    got = vt.viterbi_segs(*args).cpu().numpy()
    dense = vt.prepare_batch(hmms, queries, cuda_device, sparse=False)
    assert "T" in dense[1]
    want = vt.viterbi_plain(*dense).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[-1, :, 0] == 0).any()
