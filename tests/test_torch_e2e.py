"""The port's end-to-end aligner (trgt_tpu_torch/kernels/e2e.py), both its
classes (full matrix and band), held exactly against the JAX scan
`_e2e_scan` (direction bits) with the JAX package's `_traceback`, its
`e2e_align_batch` and the host aligner (scores and CIGARs byte for byte).
Python twins of what the CUDA kernels do otherwise than the plain versions
(the cell-by-cell insertion chain, the band's anti-diagonal order with its
packed state, the traceback that walks 32 cells a round) are held against
the plain versions. Scores are integers and every comparison is exact
(tolerance 0)."""

import random

import numpy as np
import pytest
import torch

from trgt_tpu.kernels.align_host import align_end_to_end
from trgt_tpu_torch.kernels import e2e
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


def jax_reference(pairs, scoring):
    """[(score, cigar, bits (len_p + 1, len_t + 1))] of `_e2e_scan` and the
    JAX package's host `_traceback` on the padded batch."""
    import jax.numpy as jnp
    from trgt_tpu.kernels.e2e_device import _e2e_scan, _traceback
    p_toks, t_toks, _lp, _lt = e2e.encode_problems(pairs)
    h_fin, packed = _e2e_scan(jnp.asarray(p_toks), jnp.asarray(t_toks),
                              *scoring)
    packed = np.asarray(packed)
    bits = np.empty(packed.shape[:2] + (packed.shape[2] * 2,), np.uint8)
    bits[..., 0::2] = packed & 0xF
    bits[..., 1::2] = packed >> 4
    out = []
    for b, (p, t) in enumerate(pairs):
        # `_e2e_scan` walks the pad rows too: its last row is the pair's
        # own only for the longest pattern, so the score comes from the
        # CIGAR
        own = bits[:len(p) + 1, b, :len(t) + 1]
        cigar = _traceback(own, p, t)
        cost = sum(n * scoring[0] if op == "X" else
                   scoring[1] + n * scoring[2] if op in "ID" else 0
                   for n, op in cigar)
        out.append((cost, cigar, own))
    return out


def banded(pairs, band_w, scoring, width=None):
    p_toks, t_toks, len_p, len_t = e2e.encode_problems(pairs)
    ws = np.full(len(pairs), band_w, dtype=np.int32)
    need = int(e2e.band_geometry(len_p, len_t, ws)[2].max())
    return e2e.e2e_banded_plain(
        *(torch.from_numpy(x) for x in (p_toks, t_toks, len_p, len_t, ws)),
        width or need, *scoring)


def band_pairs(seed, n):
    """Non-empty pairs for the band class: near-identical pairs, repeat
    tracts and random pairs, |T-P| on both sides of 0, some with a long
    length difference."""
    rng = random.Random(seed)
    pairs = [(p, t) for p, t in reference_fuzz_pairs(seed, n)
             + repeat_pairs(seed + 1, n) if p and t]
    for _ in range(n // 4):
        a = random_dna(rng, 40, 90)
        cut = rng.randrange(len(a))
        pairs.append((a, a[:cut] + a[cut + rng.randint(5, 30):] or a))
        pairs.append((pairs[-1][1], a))
    return pairs


@pytest.mark.parametrize("scoring", [(2, 5, 1), (1, 0, 1)])
@pytest.mark.parametrize("band_w", [2, 7, 32])
def test_banded_plain_matches_jax_and_host(scoring, band_w):
    """Every certified problem has the JAX scan's and the host aligner's
    score and CIGAR, and the full matrix's bits on every band cell of its
    traceback path; the certificate is the stated one; uncertified
    problems still trace back inside their band."""
    pairs = band_pairs(41 + band_w, 24)
    score, bits, runs, n_runs, certified = banded(pairs, band_w, scoring)
    want = jax_reference(pairs, scoring)
    mism, gapo, gape = scoring
    n_certified = 0
    for b, (p, t) in enumerate(pairs):
        lo, hi, wb = e2e.band_geometry(len(p), len(t), band_w)
        covers = lo <= -len(p) and hi >= len(t)
        bound = 2 * gapo + gape * (2 * band_w + 2 + abs(len(t) - len(p)))
        assert bool(certified[b]) == (covers or int(score[b]) < bound)
        cigar = e2e.decode_runs(runs[b, :int(n_runs[b])].tolist())
        assert sum(n for n, op in cigar if op in "=XD") == len(p)
        assert sum(n for n, op in cigar if op in "=XI") == len(t)
        assert not runs[b, int(n_runs[b]):].any()
        assert not bits[b, len(p) + 1:].any() and not bits[b, :, wb:].any()
        if not certified[b]:
            assert int(score[b]) >= want[b][0]
            continue
        n_certified += 1
        assert (int(score[b]), cigar) == want[b][:2]
        assert (int(score[b]), cigar) == align_end_to_end(p, t, *scoring)
        i, j = len(p), len(t)
        for n, op in reversed(cigar):
            for _ in range(n):
                assert bits[b, i, j - i - lo] == want[b][2][i, j], (p, t)
                i -= op in "=XD"
                j -= op in "=XI"
    assert n_certified >= len(pairs) // 3


def test_band_that_covers_the_matrix_is_the_full_matrix():
    """With a band over every diagonal no neighbour is missing: every bit
    of every cell equals `e2e_scan_plain`'s."""
    pairs = band_pairs(5, 12)
    p_toks, t_toks, len_p, len_t = e2e.encode_problems(pairs)
    args = [torch.from_numpy(x) for x in (p_toks, t_toks, len_p, len_t)]
    full = e2e.e2e_scan_plain(*args, 2, 5, 1)
    band_w = int(max(len_p.max(), len_t.max()))
    score, bits, runs, n_runs, certified = banded(pairs, band_w, (2, 5, 1))
    assert certified.all()
    assert torch.equal(score, full[0])
    assert torch.equal(n_runs, full[3])
    assert torch.equal(runs, full[2])
    for b, (p, t) in enumerate(pairs):
        lo = e2e.band_geometry(len(p), len(t), band_w)[0]
        for i in range(len(p) + 1):
            got = bits[b, i, -i - lo:len(t) + 1 - i - lo]
            assert torch.equal(got, full[1][b, i, :len(t) + 1])


def band_cell(i, j, dn_up, in_left, h_diag, match, mism, gapo, gape):
    """csrc/e2e.cu `BandCell`: (h, dn, in, bits) of one band cell."""
    inf = 1 << 29
    go_ge = gapo + gape
    pack = lambda value, flag: (value << 1) | int(flag)
    if i == 0:
        h = 0 if j == 0 else gapo + gape * j
        nv, d_row, iv = h, inf, inf
        bt = 0 if j == 0 else (2 if j == 1 else 10)
    else:
        d_row, te = dn_up >> 1, dn_up & 1
        diag = h_diag + (0 if match else mism) if j >= 1 else inf
        td = d_row < diag
        nv = d_row if td else diag
        iv, ext = in_left >> 1, in_left & 1
        ti = iv < nv
        h = iv if ti else nv
        bt = (2 if ti else (1 if td else 0)) | (te << 2) \
            | ((1 if ext or j == 0 else 0) << 3)
    return (h, pack(min(d_row + gape, h + go_ge), d_row + gape < h + go_ge),
            pack(min(iv + gape, nv + go_ge), iv + gape < nv + go_ge), bt)


def band_kernel_twin(p, t, band_w, width, mism, gapo, gape):
    """csrc/e2e.cu `e2e_band_block_kernel` step by step in Python ints:
    the anti-diagonals in order, three ints of shared state a band lane (H,
    and what the cell below takes as D and the cell to the right as I, each
    packed with its extend flag), even lanes in the first half of an array.
    Returns (score, bits (len_p + 1, width), certified)."""
    inf = 1 << 29
    lp, lt = len(p), len(t)
    lo, hi, wb = e2e.band_geometry(lp, lt, band_w)
    half = (width + 1) // 2
    slot = lambda k: (k >> 1) + (k & 1) * half
    pack = lambda value, flag: (value << 1) | int(flag)
    s_h, s_d, s_i = ([None] * (2 * half) for _ in range(3))
    bits = np.zeros((lp + 1, width), np.uint8)
    for a in range(lp + lt + 1):
        i_min = max(0, a - lt, (a - hi + 1) >> 1)
        i_max = min(lp, a, (a - lo) >> 1)
        writes = []
        for i in range(i_min, i_max + 1):
            j = a - i
            k = j - i - lo
            assert 0 <= k < wb
            both = i >= 1 and j >= 1
            dn_up = s_d[slot(k + 1)] if i >= 1 and k + 1 < wb \
                else pack(inf, False)
            in_left = s_i[slot(k - 1)] if both and k >= 1 \
                else pack(inf, False)
            h, dn, left, bt = band_cell(
                i, j, dn_up, in_left, s_h[slot(k)] if both else 0,
                both and t[j - 1] == p[i - 1], mism, gapo, gape)
            writes.append((k, h, dn, left))
            bits[i, k] = bt
        # the cells of one anti-diagonal run at once: none reads what
        # another of them writes
        for k, h, dn, left in writes:
            s_h[slot(k)], s_d[slot(k)], s_i[slot(k)] = h, dn, left
    total = s_h[slot(lt - lp - lo)]
    covers = lo <= -lp and hi >= lt
    return total, bits, covers or total < 2 * gapo + gape * (
        2 * band_w + 2 + abs(lt - lp))


@pytest.mark.parametrize("scoring", [(2, 5, 1), (1, 0, 1), (3, 2, 2)])
def test_band_kernel_twin_matches_banded_plain(scoring):
    """Every bit of every band cell, certified or not, bands narrower than
    the matrix and one lane wider than needed."""
    pairs = band_pairs(61, 16)
    for band_w in (1, 4, 9):
        _lo, _hi, wb = e2e.band_geometry(
            np.array([len(p) for p, _ in pairs]),
            np.array([len(t) for _, t in pairs]), band_w)
        width = int(wb.max()) + 1
        score, bits, _runs, _n, certified = banded(pairs, band_w, scoring,
                                                   width)
        for b, (p, t) in enumerate(pairs):
            total, twin_bits, sure = band_kernel_twin(p, t, band_w, width,
                                                      *scoring)
            assert total == int(score[b])
            assert sure == bool(certified[b])
            assert np.array_equal(twin_bits,
                                  bits[b, :len(p) + 1].numpy()), (p, t)


def band_warp_twin(p, t, band_w, CW, mism, gapo, gape, warps=1):
    """csrc/e2e.cu `e2e_band_lanes_kernel` thread for thread: CW band lanes
    a thread in registers, one value from a neighbour thread a step
    (between warps through shared memory, here the same list), the pattern
    and text bytes in two windows that shift by a byte every second step.
    Returns (score, {(i, k): bits} as the kernel's layout holds them)."""
    inf = 1 << 29
    none = (inf << 1)
    M = CW // 2
    lp, lt = len(p), len(t)
    lo, hi, wb = e2e.band_geometry(lp, lt, band_w)
    assert wb <= 32 * CW * warps
    pat_at = lambda i: p[i] if 0 <= i < lp else 0
    txt_at = lambda j: t[j] if 0 <= j < lt else 256
    first = (-lo) & 1
    lanes = range(32 * warps)
    H = [[inf] * CW for _ in lanes]
    Dn = [[none] * CW for _ in lanes]
    In = [[none] * CW for _ in lanes]
    ie = [(-lo - first - l * CW) >> 1 for l in lanes]
    pw = [[pat_at(ie[l] - m - 1) for m in range(M)] for l in lanes]
    tx = [[txt_at(-ie[l] - 1 - first + x) for x in range(M + 1)]
          for l in lanes]
    p_new = [pat_at(ie[l]) for l in lanes]
    t_new = [txt_at(-ie[l] - first + M) for l in lanes]
    stored = {}
    # the steps on which the kernel takes every band lane's cell to have
    # 1 <= i <= lp and 1 <= j <= lt
    inner, inner_end = max(hi + 2, 2 - lo), min(2 * lp + lo, 2 * lt - hi)

    def step(a, PI):
        if PI == 0:
            got = [In[max(l - 1, 0)][CW - 1] for l in lanes]       # shfl_up
        else:
            got = [Dn[min(l + 1, lanes[-1])][0] for l in lanes]    # shfl_down
        new = []
        for l in lanes:
            for m in range(M):
                x = PI + 2 * m
                k = l * CW + x
                i = ie[l] - m
                j = a - i
                if inner <= a <= inner_end and k < wb:
                    assert 1 <= i <= lp and 1 <= j <= lt
                dn_up = Dn[l][x + 1] if x + 1 < CW else got[l]
                if k + 1 >= wb:
                    dn_up = none
                in_left = In[l][x - 1] if x >= 1 else got[l]
                if j < 1 or k < 1:
                    in_left = none
                cell = band_cell(i, j, dn_up, in_left, H[l][x],
                                 pw[l][m] == tx[l][m + PI], mism, gapo, gape)
                new.append((l, x, cell))
                stored[(a, k >> 1)] = cell[3]
        for l, x, (h, dn, left, _bt) in new:
            H[l][x], Dn[l][x], In[l][x] = h, dn, left

    def advance():
        for l in lanes:
            ie[l] += 1
            pw[l] = [p_new[l]] + pw[l][:-1]
            tx[l] = tx[l][1:] + [t_new[l]]

    a = 0
    if first == 1:
        step(a, 1)
        a += 1
        advance()
    while a <= lp + lt:
        for l in lanes:
            p_new[l] = pat_at(ie[l])
            t_new[l] = txt_at(a - ie[l] + M)
        step(a, 0)
        if a + 1 <= lp + lt:
            step(a + 1, 1)
        advance()
        a += 2
    k_end = lt - lp - lo
    bits = {}
    for i in range(lp + 1):
        for k in range(wb):
            if 0 <= i + lo + k <= lt:
                bits[(i, k)] = stored[(2 * i + lo + k, k >> 1)]
    return H[k_end // CW][k_end % CW], bits


@pytest.mark.parametrize("CW, warps, band_w", [
    (4, 1, 1), (4, 1, 6), (4, 1, 32), (8, 1, 40), (4, 4, 70)])
def test_band_warp_twin_matches_banded_plain(CW, warps, band_w):
    """Every bit of every band cell, read back through the kernel's own
    layout (anti-diagonal a = i + j, byte k / 2)."""
    pairs = [(p, t) for p, t in band_pairs(81 + CW + band_w, 12)
             if abs(len(t) - len(p)) + 2 * band_w + 1 <= 32 * CW * warps]
    assert len(pairs) >= 10
    for scoring in ((2, 5, 1), (1, 0, 1)):
        score, bits, _runs, _n, _sure = banded(pairs, band_w, scoring)
        for b, (p, t) in enumerate(pairs):
            total, got = band_warp_twin(p, t, band_w, CW, *scoring, warps)
            assert total == int(score[b]), (p, t)
            lo, _hi, wb = e2e.band_geometry(len(p), len(t), band_w)
            for (i, k), bt in got.items():
                assert bt == int(bits[b, i, k]), (p, t, i, k)


def test_bits_rows_read_the_kernels_layouts():
    """`_full_bits_rows` and `_band_bits_rows` against arrays laid out as
    csrc/e2e.cu documents: the full-matrix class by tile, step and lane,
    the band class by anti-diagonal."""
    pairs = band_pairs(91, 6) + [(b"ACGT" * 30, b"ACGGT" * 40)]
    p_toks, t_toks, len_p, len_t = e2e.encode_problems(pairs)
    args = [torch.from_numpy(x) for x in (p_toks, t_toks, len_p, len_t)]
    P, T = p_toks.shape[1], t_toks.shape[1]
    _score, bits, _runs, _n = e2e.e2e_scan_plain(*args, 2, 5, 1)
    for strip in (2, 4):
        tile = 32 * strip
        flat = torch.full((len(pairs), e2e._full_bits_size(P, T, strip)),
                          255, dtype=torch.uint8)
        assert flat.shape[1] % 16 == 0
        for b, (p, t) in enumerate(pairs):
            for i in range(1, len(p) + 1):
                for j in range(len(t) + 1):
                    r = j % tile
                    flat[b, ((j // tile) * (P + 31) + i - 1 + r // strip)
                         * tile + r] = bits[b, i, j]
        assert torch.equal(e2e._full_bits_rows(flat, P, T, strip, args[2],
                                               args[3]), bits)
    ws = torch.full((len(pairs),), 3, dtype=torch.int32)
    lo, _hi, wb = e2e.band_geometry(args[2], args[3], ws)
    width = int(wb.max()) + 1
    half = ((width + 1) // 2 + 3) // 4 * 4
    band_bits = e2e.e2e_banded_plain(*args, ws, width, 2, 5, 1)[1]
    flat = torch.full((len(pairs), e2e._band_bits_size(P, T, half)), 255,
                      dtype=torch.uint8)
    for b, (p, t) in enumerate(pairs):
        for i in range(len(p) + 1):
            for k in range(int(wb[b])):
                j = i + int(lo[b]) + k
                if 0 <= j <= len(t):
                    flat[b, (i + j) * half + k // 2] = band_bits[b, i, k]
    assert torch.equal(e2e._band_bits_rows(flat, P, width, half, args[2],
                                           args[3], ws), band_bits)


def cellwise_bits(p, t, mism, gapo, gape):
    """The full-matrix kernel's cell: the insertion chain as I[j] =
    min(I[j-1] + ge, N[j-1] + go_ge), its extend bit as the strict
    comparison of the two, bit 3 set in column 0."""
    inf = 1 << 29
    go_ge = gapo + gape
    H = [0] + [gapo + gape * j for j in range(1, len(t) + 1)]
    D = [inf] * (len(t) + 1)
    bits = np.zeros((len(p) + 1, len(t) + 1), np.uint8)
    bits[0, 1:] = 10
    bits[0, 1:2] = 2
    for i in range(1, len(p) + 1):
        hl, ipe, nop = 0, inf, inf
        for j in range(len(t) + 1):
            oh = H[j]
            d_ext, d_open = D[j] + gape, oh + go_ge
            te = d_ext < d_open
            d_row = d_ext if te else d_open
            diag = inf if j == 0 else hl + (0 if t[j - 1] == p[i - 1]
                                            else mism)
            td = d_row < diag
            nv = d_row if td else diag
            ext = ipe < nop
            iv = ipe if ext else nop
            ti = iv < nv
            H[j], D[j] = (iv if ti else nv), d_row
            bits[i, j] = (2 if ti else (1 if td else 0)) | (te << 2) \
                | ((1 if ext or j == 0 else 0) << 3)
            hl, ipe, nop = oh, iv + gape, nv + go_ge
    return H[len(t)], bits


@pytest.mark.parametrize("scoring", [(2, 5, 1), (1, 0, 1), (3, 2, 2)])
def test_cellwise_chain_matches_e2e_scan(scoring):
    pairs = [(p, t) for p, t in reference_fuzz_pairs(seed=13, n=16)
             + repeat_pairs(27, 8) if p and t]
    for (p, t), (cost, _cigar, bits) in zip(pairs,
                                            jax_reference(pairs, scoring)):
        total, got = cellwise_bits(p, t, *scoring)
        assert total == cost
        assert np.array_equal(got, bits), (p, t)


def warp_traceback(cell, pattern, text):
    """csrc/e2e.cu `traceback`: 32 lanes look down the diagonal, up the
    column or along the row at once and a ballot measures the run.
    `cell(i, j)` gives a cell's bits. Returns (runs, rounds of loads)."""
    lanes = range(32)
    runs = []
    cur = [-1, 0]
    rounds = 0

    def emit(op, n):
        if n <= 0:
            return
        if op == cur[0]:
            cur[1] += n
            return
        if cur[1]:
            runs.append((cur[1] << 2) | cur[0])
        cur[:] = [op, n]

    def leading(flags):
        return next((l for l in lanes if not flags[l]), 32)

    i, j = len(pattern), len(text)
    while i > 0 or j > 0:
        rounds += 1
        bt = [cell(i - l, j - l) if i - l >= 0 and j - l >= 0 else 0
              for l in lanes]
        inside = [i - l > 0 and j - l > 0 for l in lanes]
        f = leading([inside[l] and bt[l] & 3 == 0 for l in lanes])
        for l in range(f):
            emit(0 if pattern[i - l - 1] == text[j - l - 1] else 1, 1)
        i -= f
        j -= f
        if f == 32 or (i == 0 and j == 0):
            continue
        b = bt[f]
        choice = b & 3
        if i == 0:
            choice = 2
        if j == 0 and i > 0:
            choice = 1
        assert choice != 0
        if choice == 1:
            emit(2, 1)
            ext = bool(b & 4)
            i -= 1
            while ext and i > 0:
                rounds += 1
                extending = leading([i - l > 0 and cell(i - l, j) & 4
                                     for l in lanes])
                n = min(extending + 1, i, 32)
                emit(2, n)
                ext = n < extending + 1
                i -= n
        else:
            emit(3, 1)
            ext = bool(b & 8)
            j -= 1
            while ext and j > 0:
                rounds += 1
                extending = leading([j - l > 0 and cell(i, j - l) & 8
                                     for l in lanes])
                n = min(extending + 1, j, 32)
                emit(3, n)
                ext = n < extending + 1
                j -= n
    if cur[1]:
        runs.append((cur[1] << 2) | cur[0])
    return runs, rounds


def long_gap_pairs(seed):
    """Pairs whose gap runs and diagonal runs pass the 32 cells of one
    round, on both sides, and runs that end at row or column 0."""
    rng = random.Random(seed)
    pairs = []
    for gap in (31, 32, 33, 64, 70):
        a = random_dna(rng, 80, 120)
        cut = rng.randrange(len(a) - gap)
        b = a[:cut] + a[cut + gap:]
        pairs += [(a, b), (b, a), (a, a[gap:]), (a[gap:], a),
                  (a, a[:-gap]), (a[:-gap], a)]
    pairs += [(b"A" * 40, b"C"), (b"C", b"A" * 40), (b"ACGT" * 20,) * 2]
    return pairs


def test_warp_traceback_twin_matches_traceback_runs():
    pairs = band_pairs(71, 20) + long_gap_pairs(73)
    p_toks, t_toks, len_p, len_t = e2e.encode_problems(pairs)
    args = [torch.from_numpy(x) for x in (p_toks, t_toks, len_p, len_t)]
    for scoring in ((2, 5, 1), (1, 0, 1)):
        _score, bits, runs, n_runs = e2e.e2e_scan_plain(*args, *scoring)
        band = banded(pairs, 3, scoring)
        for b, (p, t) in enumerate(pairs):
            own = bits[b].numpy()
            got, rounds = warp_traceback(lambda i, j: int(own[i, j]), p, t)
            assert got == runs[b, :int(n_runs[b])].tolist(), (p, t)
            assert rounds <= len(p) + len(t)
            if p == t:
                assert rounds == (len(p) + 31) // 32
            lo, _hi, wb = e2e.band_geometry(len(p), len(t), 3)
            own_band = band[1][b].numpy()

            def cell(i, j):
                k = j - i - lo
                return int(own_band[i, k]) if 0 <= k < wb else 0

            got, _rounds = warp_traceback(cell, p, t)
            assert got == band[2][b, :int(band[3][b])].tolist(), (p, t)


def divergent_pair(rng, n):
    """Two unrelated sequences: no narrow band certifies."""
    return random_dna(rng, n, n), random_dna(rng, n - 9, n + 9)


def count_calls(monkeypatch, name):
    """Batch sizes of every call of e2e.<name> from here on."""
    sizes = []
    orig = getattr(e2e, name)
    monkeypatch.setattr(
        e2e, name, lambda *a: sizes.append(a[0].shape[0]) or orig(*a))
    return sizes


def test_failed_certificate_is_relaunched_wider(monkeypatch):
    """A divergent pair fails the certificate at W = 32, is launched again
    at the host schedule's width and then agrees with the host aligner
    and the JAX package; a near-identical pair of the same size certifies
    in its first pass."""
    from trgt_tpu.kernels.e2e_device import e2e_align_batch as jax_batch
    rng = random.Random(43)
    near = random_dna(rng, 150, 150)
    pairs = [divergent_pair(rng, 150),
             (near, near[:70] + b"T" + near[70:]),
             divergent_pair(rng, 140)]
    scans = count_calls(monkeypatch, "e2e_scan")
    bands = count_calls(monkeypatch, "e2e_banded")
    e2e.routed.clear()
    got = e2e.e2e_align_batch(pairs, 2, 5, 1, CPU)
    assert got == [align_end_to_end(a, b, 2, 5, 1) for a, b in pairs]
    assert got == jax_batch(pairs, 2, 5, 1)
    assert scans == []
    # the two relaunched problems may differ in their band's bucket
    assert bands[0] == 3 and sum(bands[1:]) == 2
    assert e2e.routed["band_problems"] == 3
    assert e2e.routed["band_relaunches"] == 2
    assert e2e.routed["host_problems"] == 0
    assert e2e.routed["band_full_cells"] == sum(
        (len(a) + 1) * (len(b) + 1) for a, b in pairs)
    first = sum((len(a) + 1) * (abs(len(b) - len(a)) + 65) for a, b in pairs)
    assert e2e.routed["band_cells"] > first


def test_routing_counts_and_host_route(monkeypatch):
    """Empty sides are answered without a scan; a problem whose bucketed
    matrix is small takes the full-matrix class, a larger one the band
    class; one whose band passes the cap (at once, or when it is widened)
    goes to the host aligner and is counted; results do not depend on the
    route."""
    monkeypatch.setattr(e2e, "FULL_MATRIX_CELLS", 40 * 40)
    monkeypatch.setattr(e2e, "MAX_BAND_BYTES", 61 * 80)
    rng = random.Random(2)
    near = random_dna(rng, 55, 55)
    pairs = [(b"", b"AC"), (b"ACG", b""),
             (random_dna(rng, 10, 20), random_dna(rng, 10, 20)),
             (near, near[:20] + near[21:]),               # band, certified
             (random_dna(rng, 60, 60), random_dna(rng, 60, 60)),
             (near, near + random_dna(rng, 40, 40))]      # band over the cap
    scans = count_calls(monkeypatch, "e2e_scan")
    bands = count_calls(monkeypatch, "e2e_banded")
    e2e.routed.clear()
    got = e2e.e2e_align_batch(pairs, 2, 5, 1, CPU)
    assert got == [align_end_to_end(a, b, 2, 5, 1) for a, b in pairs]
    assert scans == [1]
    # the divergent 60 x 60 pair fits at W = 32 (61 * 65 bytes), fails the
    # certificate, and its wider band would pass the cap
    assert bands == [2]
    assert e2e.routed["empty_problems"] == 2
    assert e2e.routed["kernel_problems"] == 1
    assert e2e.routed["band_problems"] == 2
    assert e2e.routed["band_relaunches"] == 0
    assert e2e.routed["host_problems"] == 2
    assert e2e.routed["host_cells"] == sum(
        (len(a) + 1) * (len(b) + 1) for a, b in pairs[4:])
    assert e2e.routed["host_seconds"] > 0


def test_gape_zero_skips_the_band_class(monkeypatch):
    """The certificate needs gape >= 1: without it a problem over the
    full-matrix class goes to the host aligner."""
    monkeypatch.setattr(e2e, "FULL_MATRIX_CELLS", 40 * 40)
    rng = random.Random(4)
    pairs = [(random_dna(rng, 10, 20), random_dna(rng, 10, 20)),
             (random_dna(rng, 50, 60), random_dna(rng, 50, 60))]
    bands = count_calls(monkeypatch, "e2e_banded")
    e2e.routed.clear()
    got = e2e.e2e_align_batch(pairs, 2, 3, 0, CPU)
    assert got == [align_end_to_end(a, b, 2, 3, 0) for a, b in pairs]
    assert bands == []
    assert e2e.routed["kernel_problems"] == 1
    assert e2e.routed["host_problems"] == 1


def test_launch_bound_chunks_a_group(monkeypatch):
    """Both classes cut a group into launches within MAX_BITS_BYTES of
    direction bits, reckoned in the kernels' own layouts at the group's
    bucketed sizes."""
    monkeypatch.setattr(e2e, "MAX_BITS_BYTES",
                        2 * e2e._full_bits_size(24, 24, 16))
    rng = random.Random(3)
    pairs = [(random_dna(rng, 17, 24), random_dna(rng, 17, 24))
             for _ in range(5)]
    sizes = count_calls(monkeypatch, "e2e_scan")
    got = e2e.e2e_align_batch(pairs, 2, 5, 1, CPU)
    assert sizes == [2, 2, 1]
    assert got == [align_end_to_end(a, b, 2, 5, 1) for a, b in pairs]
    monkeypatch.setattr(e2e, "FULL_MATRIX_CELLS", 0)
    monkeypatch.setattr(e2e, "MAX_BITS_BYTES",
                        3 * e2e._band_bits_size(24, 24 + 96, 96 // 2 + 4))
    pairs = [(p, p[:9] + p[10:]) for p, _ in pairs]        # Wb 66 → 96
    sizes = count_calls(monkeypatch, "e2e_banded")
    got = e2e.e2e_align_batch(pairs, 2, 5, 1, CPU)
    assert sizes == [3, 2]
    assert got == [align_end_to_end(a, b, 2, 5, 1) for a, b in pairs]


def test_dispatch_rejects_other_devices():
    meta = lambda *shape: torch.empty(shape, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        e2e.e2e_scan(meta(1, 4), meta(1, 4), meta(1), meta(1), 2, 5, 1)


def test_banded_dispatch_rejects_other_devices():
    meta = lambda *shape: torch.empty(shape, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        e2e.e2e_banded(meta(1, 4), meta(1, 4), meta(1), meta(1), meta(1), 9,
                       2, 5, 1)


def test_banded_plain_rejects_rows_too_narrow_for_a_band():
    with pytest.raises(ValueError, match="exceeds"):
        banded([(b"ACGTACGT", b"ACGT")], 2, (2, 5, 1), width=8)


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
    near = random_dna(rng, 2000, 2000)
    pairs += [(near, near[:900] + near[1000:]), (near[:1500], near)]
    for scoring in ((2, 5, 1), (1, 0, 1)):
        before = (telemetry.count("e2e_full"),
                  telemetry.count("e2e_band"))
        got = e2e.e2e_align_batch(pairs, *scoring, dev)
        assert telemetry.count("e2e_full") > before[0] and \
            telemetry.count("e2e_band") > before[1]
        assert got == [align_end_to_end(a, b, *scoring) for a, b in pairs]
        args = [torch.from_numpy(x).to(dev)
                for x in e2e.encode_problems(pairs[:-2])]
        for g, w in zip(e2e.e2e_scan(*args, *scoring),
                        e2e.e2e_scan_plain(*args, *scoring)):
            assert torch.equal(g, w)
        ws = torch.full((len(pairs) - 2,), 5, dtype=torch.int32, device=dev)
        width = int(e2e.band_geometry(args[2], args[3], ws)[2].max())
        for g, w in zip(e2e.e2e_banded(*args, ws, width, *scoring),
                        e2e.e2e_banded_plain(*args, ws, width, *scoring)):
            assert torch.equal(g, w)
