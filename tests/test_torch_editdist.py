"""The port's edit distance (trgt_tpu_torch/kernels/editdist.py) held
exactly against the Pallas kernel `_edit_kernel` (interpret mode on the
CPU), the XLA scan `_edit_scan` and the host twin; and a numpy twin of
the CUDA kernel's step (csrc/editdist.cu: strips of columns over 32 lanes,
a min-scan for the value entering each strip, tiles of 128 columns) held
against the same three. Distances are integers and every comparison is
exact (tolerance 0)."""

import random

import numpy as np
import pytest
import torch

from trgt_tpu.kernels.align_host import edit_distance
from trgt_tpu_torch.kernels import editdist as ed
from trgt_tpu_torch.kernels import telemetry

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


def kernel_twin(a: bytes, b: bytes, trace=None) -> int:
    """csrc/editdist.cu `edit_kernel` for one pair, lane for lane: a lane
    owns CW neighbouring columns of a tile of 32 * CW; pass 1 computes pre
    and the strip's own chain, an inclusive min-scan of (strip's last value
    - CW * lane) over the lanes gives the value entering each strip, pass 2
    folds it in; the last column of every row waits for the next tile."""
    CW, INF = 4, 1 << 29
    la, lb = len(a), len(b)
    lane = np.arange(32)
    edge = [np.zeros(la + 1, np.int64), np.zeros(la + 1, np.int64)]
    result = None
    for tile, t0 in enumerate(range(0, lb + 1, 32 * CW)):
        edge_in, edge_out = edge[tile & 1], edge[(tile + 1) & 1]
        j = t0 + lane[:, None] * CW + np.arange(CW)[None, :]      # (32, CW)
        H = j.astype(np.int64)                                     # row 0
        bw = np.array([[b[c - 1] if 1 <= c <= lb else -1 for c in row]
                       for row in j])
        edge_out[0] = H[31, CW - 1]
        for i in range(1, la + 1):
            hl = np.roll(H[:, CW - 1], 1)
            enter = INF
            if t0 > 0:
                hl[0] = edge_in[i - 1]
                enter = edge_in[i]
            run = np.full(32, INF, np.int64)
            for c in range(CW):
                oh = H[:, c].copy()
                pre = oh + 1
                diag = hl + (bw[:, c] != a[i - 1])
                pre = np.where(j[:, c] >= 1, np.minimum(pre, diag), pre)
                run = np.minimum(pre, run + 1)
                H[:, c] = run
                hl = oh
            scan = run - CW * lane
            o = 1
            while o < 32:
                up = np.roll(scan, o)
                scan = np.where(lane >= o, np.minimum(scan, up), scan)
                o *= 2
            before = np.roll(scan, 1)
            before[0] = INF
            cin = np.minimum(before + CW * (lane - 1), enter + CW * lane)
            for c in range(CW):
                H[:, c] = np.minimum(H[:, c], cin + c + 1)
            edge_out[i] = H[31, CW - 1]
        if trace is not None:
            trace.append(t0)
        if t0 + 32 * CW > lb:
            result = int(H[(lb - t0) // CW, lb % CW])
    return result


def test_kernel_twin_matches_pallas_interpret_scan_and_host():
    """Short sides on both sides of 32, 64 and 100, `b` on both sides of
    one and two tiles, empty sides."""
    import jax.numpy as jnp
    from trgt_tpu.kernels.editdist import _edit_scan
    from trgt_tpu.kernels.editdist_pallas import edit_distances_batch_pallas
    rng = random.Random(17)
    pairs = fuzz_pairs(23, 16, hi=100, lo=0)
    for la in (1, 31, 32, 33, 63, 64, 65, 99, 100):
        lb = rng.choice([la, 10000 // la])
        a = random_dna(rng, la, la)
        pairs.append((a, (a * (lb // la + 1))[:lb]))
        pairs.append((a, random_dna(rng, lb, lb)))
    for lb in (126, 127, 128, 129, 255, 256, 257):
        pairs.append((random_dna(rng, 30, 39), random_dna(rng, lb, lb)))
    pairs += [(b"", b""), (b"", b"ACGT"), (b"", random_dna(rng, 300, 300))]
    pairs = [(a, b) if len(a) <= len(b) else (b, a) for a, b in pairs]
    got = [kernel_twin(a, b) for a, b in pairs]
    assert got == [edit_distance(a, b) for a, b in pairs]
    assert got == edit_distances_batch_pallas(pairs, interpret=True)
    small = [(a, b) for a, b in pairs if len(b) <= 128]
    a_toks, b_toks, _len_a, len_b = ed.encode_pairs(small, 128)
    H = np.asarray(_edit_scan(jnp.asarray(a_toks), jnp.asarray(b_toks)))
    assert [kernel_twin(a, b) for a, b in small] == \
        [int(H[i, len_b[i]]) for i in range(len(small))]


def test_kernel_twin_walks_len_b_over_128_tiles():
    """The chain of one pair: (len_b // 128 + 1) tiles of len_a rows, not
    len_a * len_b cells."""
    rng = random.Random(19)
    trace = []
    b = random_dna(rng, 10000, 10000)
    assert kernel_twin(b"G", b, trace) == edit_distance(b"G", b)
    assert trace == list(range(0, 10001, 128))


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
    pairs += [(b"", b""), (b"C", random_dna(rng, 10000, 10000)),
              (b"", random_dna(rng, 300, 300))]
    # short sides on both sides of 32, 64 and 100, long sides over a tile
    for la in (31, 32, 33, 63, 64, 65, 99, 100):
        pairs.append((random_dna(rng, la, la),
                      random_dna(rng, 10000 // la, 10000 // la)))
    before = telemetry.count("editdist")
    got = ed.edit_distances_batch(pairs, dev)
    assert telemetry.count("editdist") > before
    assert got == [edit_distance(a, b) for a, b in pairs]
    norm = [(a, b) if len(a) <= len(b) else (b, a) for a, b in pairs[:600]]
    args = [torch.from_numpy(x).to(dev) for x in ed.encode_pairs(norm, 128)]
    assert torch.equal(ed.edit_distances(*args),
                       ed.edit_distances_plain(*args))
    wide = torch.zeros((1, ed.MAX_A + 1), dtype=torch.uint8, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="wide"):
        ed.edit_distances(wide, wide, one, one)
