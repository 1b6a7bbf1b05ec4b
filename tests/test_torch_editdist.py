"""The port's edit distance (trgt_tpu_torch/kernels/editdist.py) held
exactly against the Pallas kernel `_edit_kernel` (interpret mode on the
CPU), the XLA scan `_edit_scan` and the host twin. Distances are integers
and every comparison is exact (tolerance 0)."""

import random

import numpy as np
import pytest
import torch

from trgt_tpu.kernels.align_host import edit_distance
from trgt_tpu_torch.kernels import editdist as ed

# The JAX package is imported inside the tests that compare with it, so
# the `cuda` test of this file also runs where JAX is not installed:
#   python -m pytest --noconftest tests/test_torch_*.py -m cuda

CPU = torch.device("cpu")
# the plain versions issue many tiny ops: with several test workers on
# one machine, more than one intra-op thread each oversubscribes the cores
torch.set_num_threads(1)


def random_dna(rng, lo, hi):
    return bytes(rng.choice(b"ACGT") for _ in range(rng.randint(lo, hi)))


def fuzz_pairs(seed, n, hi=90, lo=1):
    """Random pairs and near-identical repeat tracts with a few edits."""
    rng = random.Random(seed)
    pairs = []
    for i in range(n):
        if i % 2:
            pairs.append((random_dna(rng, lo, hi), random_dna(rng, lo, hi)))
        else:
            a = (random_dna(rng, 1, 6) * hi)[:rng.randint(max(lo, 1), hi)]
            b = bytearray(a)
            for _ in range(rng.randint(0, 4)):
                pos = rng.randrange(len(b) + 1)
                b[pos:pos + rng.randint(0, 1)] = random_dna(rng, 0, 1)
            pairs.append((a, bytes(b) or a))
    return pairs


def test_batch_matches_pallas_interpret_and_host():
    from trgt_tpu.kernels.editdist_pallas import edit_distances_batch_pallas
    pairs = fuzz_pairs(21, 24)
    got = ed.edit_distances_batch(pairs, CPU)
    assert got == edit_distances_batch_pallas(pairs, interpret=True)
    assert got == [edit_distance(a, b) for a, b in pairs]


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_matches_edit_scan(seed):
    """The same padded tensors through `_edit_scan` and the plain version."""
    import jax.numpy as jnp
    from trgt_tpu.kernels.editdist import _edit_scan
    pairs = [(a, b) if len(a) <= len(b) else (b, a)
             for a, b in fuzz_pairs(seed, 20, hi=70)]
    a_toks, b_toks, len_a, len_b = ed.encode_pairs(pairs, 96)
    H = np.asarray(_edit_scan(jnp.asarray(a_toks), jnp.asarray(b_toks)))
    want = [int(H[i, len_b[i]]) for i in range(len(pairs))]
    got = ed.edit_distances_plain(*(torch.from_numpy(x) for x in
                                    (a_toks, b_toks, len_a, len_b)))
    assert got.dtype == torch.int32
    assert got.tolist() == want


def test_zero_length_sides_and_long_thin_pairs():
    rng = random.Random(5)
    pairs = [(b"", b""), (b"", b"ACGT"), (b"ACGT", b""), (b"A", b"A"),
             (b"A", random_dna(rng, 10000, 10000)),
             (random_dna(rng, 3000, 3000), b"G")]
    got = ed.edit_distances_batch(pairs, CPU)
    assert got == [edit_distance(a, b) for a, b in pairs]
    assert got[:3] == [0, 4, 4]


def test_lengths_decide_not_padding():
    """Explicit lengths: bytes past a length never enter a distance, and a
    length past the width is clamped to it."""
    a = torch.tensor([[65, 67, 71, 84], [65, 67, 71, 84]], dtype=torch.uint8)
    b = torch.tensor([[65, 67, 71, 84, 84], [65, 67, 71, 84, 84]],
                     dtype=torch.uint8)
    got = ed.edit_distances_plain(a, b, torch.tensor([2, 9], dtype=torch.int32),
                                  torch.tensor([3, 9], dtype=torch.int32))
    assert got.tolist() == [edit_distance(b"AC", b"ACG"),
                            edit_distance(b"ACGT", b"ACGTT")]


def test_batch_rejects_a_pair_the_kernel_cannot_take():
    long = b"A" * (ed.MAX_A + 1)
    with pytest.raises(ValueError, match="over"):
        ed.edit_distances_batch([(long, long)], CPU)


def test_dispatch_rejects_other_devices():
    meta = lambda *shape: torch.empty(shape, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ed.edit_distances(meta(1, 4), meta(1, 4), meta(1), meta(1))


def test_empty_batch():
    assert ed.edit_distances_batch([], CPU) == []


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_and_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = random.Random(9)
    pairs = fuzz_pairs(8, 600, hi=100, lo=0)
    pairs += [(b"", b""), (b"C", random_dna(rng, 10000, 10000))]
    before = ed.launches
    got = ed.edit_distances_batch(pairs, dev)
    assert ed.launches > before
    assert got == [edit_distance(a, b) for a, b in pairs]
    norm = [(a, b) if len(a) <= len(b) else (b, a) for a, b in pairs[:600]]
    args = [torch.from_numpy(x).to(dev) for x in ed.encode_pairs(norm, 128)]
    assert torch.equal(ed.edit_distances(*args),
                       ed.edit_distances_plain(*args))
    wide = torch.zeros((1, ed.MAX_A + 1), dtype=torch.uint8, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="wide"):
        ed.edit_distances(wide, wide, one, one)
