"""The port's flank alignment (trgt_tpu_torch/kernels/semiglobal.py) held
exactly against the Pallas flank kernels (interpret mode on the CPU), the
JAX package's batched entry point and the host twin. Every comparison is
exact: integer-valued scores, match counts and spans.

The CUDA kernel picks its class (a warp or a block per problem), its
strip and its tiles from the padded text width; `edge_problems` makes
texts one column to either side of each such width. On the CPU they go
through `flank_align_batch_multi` (grouping, chunking and output order
are the wrapper's and the same for both devices); the `cuda` cases send
the same problems through the kernel."""

import random

import numpy as np
import pytest
import torch

from trgt_tpu.kernels.align_host import align_ends_free_text
from trgt_tpu_torch.kernels import semiglobal as sg
from trgt_tpu_torch.kernels import telemetry

# The JAX package is imported inside the tests that compare with it, so
# the `cuda` tests of this file also run where JAX is not installed:
#   python -m pytest --noconftest tests/test_torch_*.py -m cuda


def flank_align_batch_pallas(*args):
    from trgt_tpu.kernels.semiglobal_pallas import flank_align_batch_pallas
    return flank_align_batch_pallas(*args)


def jax_flank_align_batch_multi(*args):
    from trgt_tpu.kernels.semiglobal import flank_align_batch_multi
    return flank_align_batch_multi(*args)


CPU = torch.device("cpu")
# the plain versions issue many tiny ops: with several test workers on
# one machine, more than one intra-op thread each oversubscribes the cores
torch.set_num_threads(1)


def random_dna(rng, n):
    return bytes(rng.choice(b"ACGT") for _ in range(n))


def mutate(rng, seq, rate):
    out = bytearray()
    for c in seq:
        r = rng.random()
        if r < rate / 3:
            continue
        out.append(rng.choice(b"ACGT") if r < 2 * rate / 3 else c)
        if rng.random() < rate / 3:
            out.append(rng.choice(b"ACGT"))
    return bytes(out)


def fuzz_problems(seed, n, plen, tlen_choices, dup_every=7):
    rng = random.Random(seed)
    patterns, texts = [], []
    for i in range(n):
        pattern = random_dna(rng, plen)
        tlen = rng.choice(tlen_choices)
        mid = mutate(rng, pattern, rng.choice([0.0, 0.1, 0.3]))
        if i % dup_every == 0:
            mid = mid + mid                    # duplicate implant: ties
        left = random_dna(rng, rng.randint(0, tlen // 3))
        right = random_dna(rng, rng.randint(0, tlen // 3))
        text = (left + mid + right)[:tlen] or b"A"
        patterns.append(pattern)
        texts.append(text)
    return patterns, texts


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_plain_matches_pallas_segmented_route():
    # texts < 512: the Pallas leaf packs them into 64/128/256 segments;
    # odd count (pad segments) and duplicated implants (ties)
    patterns, texts = fuzz_problems(77, 37, 40, [28, 60, 120, 250, 480])
    want = flank_align_batch_pallas(patterns, texts, 2, 5, 1)
    got = sg.flank_align_batch_multi(patterns, texts, 2, 5, 1, CPU)
    assert got == want


def test_plain_matches_pallas_full_route():
    # texts >= 512 take the one-problem-per-row kernel
    patterns, texts = fuzz_problems(5, 7, 50, [520, 700, 900], dup_every=3)
    patterns = [patterns[0]] * len(texts)
    want = flank_align_batch_pallas(patterns, texts, 2, 5, 1)
    got = sg.flank_align_batch_multi(patterns, texts, 2, 5, 1, CPU)
    assert got == want


def test_plain_matches_pallas_mixed_routes():
    rng = random.Random(123)
    pattern = random_dna(rng, 50)
    texts = []
    for tl in (30, 500, 64, 400, 31, 505, 90):
        base = mutate(rng, pattern, 0.15)
        filler = random_dna(rng, max(0, tl - len(base)))
        texts.append((base + filler)[:tl])
    patterns = [pattern] * len(texts)
    want = flank_align_batch_pallas(patterns, texts, 2, 5, 1)
    got = sg.flank_align_batch_multi(patterns, texts, 2, 5, 1, CPU)
    assert got == want


@pytest.mark.parametrize("scoring", [(2, 5, 1), (1, 0, 1)])
def test_plain_matches_jax_batch_multi(scoring):
    patterns, texts = fuzz_problems(31, 24, 45, [40, 90, 200, 600])
    want = jax_flank_align_batch_multi(patterns, texts, *scoring)
    got = sg.flank_align_batch_multi(patterns, texts, *scoring, CPU)
    assert got == want


@pytest.mark.parametrize("scoring", [(2, 5, 1), (1, 0, 1)])
def test_plain_matches_host_twin(scoring):
    patterns, texts = fuzz_problems(1234, 60, 30, [20, 45, 80, 150])
    got = sg.flank_align_batch_multi(patterns, texts, *scoring, CPU)
    for p, t, (score, matches, span) in zip(patterns, texts, got):
        h_score, h_matches, _, h_span = align_ends_free_text(p, t, *scoring)
        assert (score, matches, span) == (h_score, h_matches, h_span)


def test_plain_matches_host_on_texts_over_8192():
    # wider than the Pallas kernel's VMEM cap: the port covers every width
    rng = random.Random(99)
    pattern = random_dna(rng, 250)
    texts = [random_dna(rng, 4000) + mutate(rng, pattern, 0.05)
             + random_dna(rng, 4500),
             random_dna(rng, 9000) + pattern + random_dna(rng, 3000),
             random_dna(rng, 8500)]
    got = sg.flank_align_batch_multi([pattern] * 3, texts, 2, 5, 1, CPU)
    for t, (score, matches, span) in zip(texts, got):
        h_score, h_matches, _, h_span = align_ends_free_text(
            pattern, t, 2, 5, 1)
        assert (score, matches, span) == (h_score, h_matches, h_span)


def test_mismatch_edged_spans():
    pattern = b"ACGTACGTACGTACGTACGT"
    core = b"T" + pattern[1:-1] + b"A"
    texts = [b"GGGGG" + core + b"CCCCC", core, b"G" + core]
    got = sg.flank_align_batch_multi([pattern] * 3, texts, 2, 5, 1, CPU)
    for t, (score, matches, span) in zip(texts, got):
        h_score, h_matches, _, h_span = align_ends_free_text(
            pattern, t, 2, 5, 1)
        assert (score, matches, span) == (h_score, h_matches, h_span)
        assert matches == len(pattern) - 2
    # the span includes the mismatch columns at both ends
    assert got[0][2] == (5, 5 + len(core))


# padded widths at which csrc/flank.cu changes strip (64, 128, 256), class
# (512: the widest warp-class width) and block shape (1024, 2048); beyond,
# a tile is 4096 columns
KERNEL_EDGES = [64, 128, 256, 512, 1024, 2048]


def edge_problems(edge, plen, seed, ragged=True):
    """Texts of edge-2 .. edge+1 bytes (edge-1 is the longest text of the
    padded width `edge`), three of each, an implant of the pattern in
    each; with `ragged`, patterns of unequal length, so some end in pad
    rows (the JAX entry points want equal lengths)."""
    rng = random.Random(seed)
    patterns, texts = [], []
    for tlen in (edge - 2, edge - 1, edge, edge + 1):
        for rep in range(3):
            pattern = random_dna(rng, plen - 3 * rep if ragged else plen)
            core = mutate(rng, pattern, [0.0, 0.1, 0.3][rep])
            if rep == 2:
                core = core + core             # duplicate implant: ties
            left = random_dna(rng, rng.randint(0, max(0, tlen - len(core))))
            patterns.append(pattern)
            texts.append((left + core + random_dna(rng, tlen))[:tlen])
    return patterns, texts


@pytest.mark.parametrize("edge", [64, 128, 256, 512])
def test_class_edges_match_pallas_and_host(edge):
    # 510..513 columns straddle the Pallas leaf's own switch from the
    # segmented kernel to the one-problem-per-row kernel as well
    patterns, texts = edge_problems(edge, 40, edge, ragged=False)
    got = sg.flank_align_batch_multi(patterns, texts, 2, 5, 1, CPU)
    assert got == flank_align_batch_pallas(patterns, texts, 2, 5, 1)
    for p, t, (score, matches, span) in zip(patterns, texts, got):
        h_score, h_matches, _, h_span = align_ends_free_text(p, t, 2, 5, 1)
        assert (score, matches, span) == (h_score, h_matches, h_span)


@pytest.mark.parametrize("edge", [1024, 2048])
def test_tile_edges_match_host(edge):
    patterns, texts = edge_problems(edge, 30, edge)
    got = sg.flank_align_batch_multi(patterns, texts, 2, 5, 1, CPU)
    for p, t, (score, matches, span) in zip(patterns, texts, got):
        h_score, h_matches, _, h_span = align_ends_free_text(p, t, 2, 5, 1)
        assert (score, matches, span) == (h_score, h_matches, h_span)


def test_empty_and_one_byte_texts():
    pattern = b"ACGTAC"
    texts = [b"", b"A", b"C", b"AC"]
    got = sg.flank_align_batch_multi([pattern] * 4, texts, 2, 5, 1, CPU)
    assert got == jax_flank_align_batch_multi([pattern] * 4, texts, 2, 5, 1)
    # all of the pattern deleted: gap open + extend, then five extends
    assert got[0] == (11.0, 0, (0, 0))
    # (the host twin answers an empty text with score 0 without aligning)
    for t, (score, matches, span) in list(zip(texts, got))[1:]:
        h_score, h_matches, _, h_span = align_ends_free_text(
            pattern, t, 2, 5, 1)
        assert (score, matches, span) == (h_score, h_matches, h_span)


def test_output_order_survives_grouping_and_chunking(monkeypatch):
    # widths interleaved, and chunks of a few problems: results come back
    # in input order
    patterns, texts = [], []
    for edge in (64, 512, 128, 1024, 256):
        p, t = edge_problems(edge, 25, edge + 1)
        patterns += p[::3]
        texts += t[::3]
    whole = sg.flank_align_batch_multi(patterns, texts, 2, 5, 1, CPU)
    monkeypatch.setattr(sg, "MAX_CHUNK_CELLS", 3000)
    assert sg.flank_align_batch_multi(patterns, texts, 2, 5, 1,
                                      CPU) == whole
    for p, t, (score, matches, span) in zip(patterns, texts, whole):
        h_score, h_matches, _, h_span = align_ends_free_text(p, t, 2, 5, 1)
        assert (score, matches, span) == (h_score, h_matches, h_span)


def test_wrapper_rejects_other_devices():
    t = torch.zeros((1, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sg.flank_align(t, t, torch.zeros(1, dtype=torch.int32,
                                         device="meta"), 2, 6, 1)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    patterns, texts = fuzz_problems(7, 300, 250, [30, 300, 700, 5000,
                                                  16384])
    launches = telemetry.count("flank")
    for width in sorted({len(t) + 1 for t in texts}):
        idx = [i for i, t in enumerate(texts) if len(t) + 1 == width]
        pat, txt, lens = sg.encode_problems([patterns[i] for i in idx],
                                            [texts[i] for i in idx], width)
        args = [torch.from_numpy(a).to(cuda_device)
                for a in (pat, txt, lens)]
        got = sg.flank_align(*args, 2, 6, 1).cpu()
        want = sg.flank_align_plain(*args, 2, 6, 1).cpu()
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert telemetry.count("flank") > launches


@pytest.mark.cuda
@pytest.mark.parametrize("edge", KERNEL_EDGES + [4096, 8192])
def test_cuda_kernel_class_edges(cuda_device, edge):
    patterns, texts = edge_problems(edge, 250, edge)
    patterns += [patterns[0]] * 2
    texts += [b"", b"A"]
    launches = telemetry.count("flank")
    got = sg.flank_align_batch_multi(patterns, texts, 2, 5, 1, cuda_device)
    assert telemetry.count("flank") > launches
    assert got == sg.flank_align_batch_multi(patterns, texts, 2, 5, 1, CPU)
