"""The port's end-to-end aligner (trgt_tpu_torch/kernels/e2e.py) held
exactly against the JAX scan `_e2e_scan` (direction bits), the JAX
package's `e2e_align_batch` and the host aligner (scores and CIGARs byte
for byte). Scores are integers and every comparison is exact
(tolerance 0)."""

import random

import numpy as np
import pytest
import torch

from trgt_tpu.kernels.align_host import align_end_to_end
from trgt_tpu_torch.kernels import e2e

# The JAX package is imported inside the tests that compare with it, so
# the `cuda` test of this file also runs where JAX is not installed:
#   python -m pytest --noconftest tests/test_torch_*.py -m cuda

CPU = torch.device("cpu")
# the plain versions issue many tiny ops: with several test workers on
# one machine, more than one intra-op thread each oversubscribes the cores
torch.set_num_threads(1)


def random_dna(rng, lo, hi):
    return bytes(rng.choice(b"ACGT") for _ in range(rng.randint(lo, hi)))


def reference_fuzz_pairs(seed=7, n=60):
    """The pairs of tests/test_e2e_device.py::
    test_e2e_device_cigars_byte_identical_to_host: near-identical pairs
    (the consensus-repair workload) and random pairs."""
    rng = random.Random(seed)
    pairs = []
    for _ in range(n):
        if rng.random() < 0.5:
            a = random_dna(rng, 5, 80)
            b = bytearray(a)
            for _ in range(rng.randint(0, 4)):
                op = rng.random()
                pos = rng.randrange(max(1, len(b)))
                if op < 0.5:
                    b[pos:pos + 1] = bytes([rng.choice(b"ACGT")])
                elif op < 0.75:
                    b[pos:pos] = bytes([rng.choice(b"ACGT")])
                else:
                    del b[pos:pos + 1]
            pairs.append((a, bytes(b)))
        else:
            pairs.append((random_dna(rng, 1, 60), random_dna(rng, 1, 60)))
    return pairs


def repeat_pairs(seed, n):
    """Repeat tracts against copies with whole motifs inserted or
    deleted: many co-optimal alignments, so every tie rule decides."""
    rng = random.Random(seed)
    pairs = []
    for _ in range(n):
        motif = random_dna(rng, 1, 5)
        copies = rng.randint(3, 25)
        a = motif * copies
        b = motif * max(1, copies + rng.randint(-3, 3))
        if rng.random() < 0.5:
            pos = rng.randrange(len(b))
            b = b[:pos] + random_dna(rng, 1, 1) + b[pos + 1:]
        pairs.append((a, b))
    return pairs


@pytest.mark.parametrize("scoring", [(2, 5, 1), (1, 0, 1)])
def test_cigars_byte_identical_to_host_and_jax(scoring):
    from trgt_tpu.kernels.e2e_device import e2e_align_batch as jax_batch
    pairs = reference_fuzz_pairs() + repeat_pairs(19, 20)
    pairs += [(b"ACGT", b""), (b"", b"ACGT"), (b"", b"")]
    got = e2e.e2e_align_batch(pairs, *scoring, CPU)
    assert got == [align_end_to_end(a, b, *scoring) for a, b in pairs]
    assert got == jax_batch(pairs, *scoring)


@pytest.mark.parametrize("scoring", [(2, 5, 1), (1, 0, 1), (3, 2, 2)])
def test_bits_match_e2e_scan(scoring):
    """The same padded tensors through `_e2e_scan` and the plain version:
    bits compared on rows <= len(p), columns <= len(t); the plain version
    is 0 outside."""
    import jax.numpy as jnp
    from trgt_tpu.kernels.e2e_device import _e2e_scan
    pairs = reference_fuzz_pairs(seed=11, n=16) + repeat_pairs(23, 8)
    pairs = [(p, t) for p, t in pairs if p and t]
    p_toks, t_toks, len_p, len_t = e2e.encode_problems(pairs)
    _H, packed = _e2e_scan(jnp.asarray(p_toks), jnp.asarray(t_toks),
                           *scoring)
    packed = np.asarray(packed)                       # (P+1, B, ceil/2)
    want = np.empty(packed.shape[:2] + (packed.shape[2] * 2,), np.uint8)
    want[..., 0::2] = packed & 0xF
    want[..., 1::2] = packed >> 4
    score, bits, runs, n_runs = e2e.e2e_scan_plain(
        *(torch.from_numpy(x) for x in (p_toks, t_toks, len_p, len_t)),
        *scoring)
    bits = bits.numpy()
    assert bits.dtype == np.uint8
    for b, (p, t) in enumerate(pairs):
        lp, lt = len(p), len(t)
        assert np.array_equal(bits[b, :lp + 1, :lt + 1],
                              want[:lp + 1, b, :lt + 1]), (p, t)
        assert not bits[b, lp + 1:].any() and not bits[b, :, lt + 1:].any()
        h_score, h_cigar = align_end_to_end(p, t, *scoring)
        assert int(score[b]) == h_score
        cigar = e2e.decode_runs(runs[b, :int(n_runs[b])].tolist())
        assert cigar == h_cigar
        assert not runs[b, int(n_runs[b]):].any()


def test_routing_counts_and_host_route(monkeypatch):
    """Empty sides are answered without a scan, problems over the bucketed
    cell bound go to the host aligner, the rest to the scan; results do
    not depend on the route."""
    monkeypatch.setattr(e2e, "MAX_DEVICE_CELLS", 40 * 40)
    rng = random.Random(2)
    pairs = [(b"", b"AC"), (b"ACG", b""),
             (random_dna(rng, 10, 20), random_dna(rng, 10, 20)),
             (random_dna(rng, 50, 60), random_dna(rng, 50, 60)),
             (random_dna(rng, 50, 60), random_dna(rng, 50, 60))]
    scans = []
    orig = e2e.e2e_scan
    monkeypatch.setattr(e2e, "e2e_scan",
                        lambda *a: scans.append(a[0].shape[0]) or orig(*a))
    e2e.routed.clear()
    got = e2e.e2e_align_batch(pairs, 2, 5, 1, CPU)
    assert got == [align_end_to_end(a, b, 2, 5, 1) for a, b in pairs]
    assert scans == [1]
    assert e2e.routed["empty_problems"] == 2
    assert e2e.routed["kernel_problems"] == 1
    assert e2e.routed["host_problems"] == 2
    assert e2e.routed["host_cells"] == sum(
        (len(a) + 1) * (len(b) + 1) for a, b in pairs[3:])


def test_launch_bound_chunks_a_group(monkeypatch):
    monkeypatch.setattr(e2e, "MAX_BITS_BYTES", 2 * 25 * 25)
    rng = random.Random(3)
    pairs = [(random_dna(rng, 17, 24), random_dna(rng, 17, 24))
             for _ in range(5)]
    sizes = []
    orig = e2e.e2e_scan
    monkeypatch.setattr(e2e, "e2e_scan",
                        lambda *a: sizes.append(a[0].shape[0]) or orig(*a))
    got = e2e.e2e_align_batch(pairs, 2, 5, 1, CPU)
    assert sizes == [2, 2, 1]
    assert got == [align_end_to_end(a, b, 2, 5, 1) for a, b in pairs]


def test_dispatch_rejects_other_devices():
    meta = lambda *shape: torch.empty(shape, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        e2e.e2e_scan(meta(1, 4), meta(1, 4), meta(1), meta(1), 2, 5, 1)


def test_empty_batch():
    assert e2e.e2e_align_batch([], 2, 5, 1, CPU) == []


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_and_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = random.Random(31)
    pairs = reference_fuzz_pairs() + repeat_pairs(29, 30)
    pairs += [(random_dna(rng, 300, 700), random_dna(rng, 300, 700))
              for _ in range(4)]
    for scoring in ((2, 5, 1), (1, 0, 1)):
        before = e2e.launches
        got = e2e.e2e_align_batch(pairs, *scoring, dev)
        assert e2e.launches > before
        assert got == [align_end_to_end(a, b, *scoring) for a, b in pairs]
        args = [torch.from_numpy(x).to(dev)
                for x in e2e.encode_problems(pairs)]
        for g, w in zip(e2e.e2e_scan(*args, *scoring),
                        e2e.e2e_scan_plain(*args, *scoring)):
            assert torch.equal(g, w)
