"""The port's Viterbi (trgt_tpu_torch/kernels/viterbi.py) held exactly
against the JAX device function `viterbi_batch_multi` / `_viterbi_full`
on the CPU and against the host twin `Hmm.label`; the port's numpy tables
against `_stack_tables`. Every comparison is exact: state paths and
segment arrays as integers, tables array by array."""

import random

import numpy as np
import pytest
import torch

from trgt_tpu.hmm import build_hmm
from trgt_tpu_torch.kernels import viterbi as vt
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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    rng = random.Random(3)
    motif_sets = [[b"CAG"], [b"CAG", b"A"], [b"AATGG", b"CCATTTTAGG"]]
    launches = vt.launches
    for ms in motif_sets:
        hmm = build_hmm(ms)
        queries = [random_repeat(rng, ms, n, 0.05) for n in (3, 30, 300)]
        args = vt.prepare_batch([hmm] * 3, queries, cuda_device)
        got = vt.viterbi_segs(*args).cpu().numpy()
        want = vt.viterbi_plain(*args).cpu().numpy()
        np.testing.assert_array_equal(got, want)
    assert vt.launches > launches
