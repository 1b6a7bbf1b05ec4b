"""Work counters of the port's kernels (counterpart of
`trgt_tpu/kernels/telemetry.py`).

For each kernel class the counters hold, per process:

  calls      batches handed to the kernel's dispatch by its batch entry
             point (`flank_align_batch_multi`, `viterbi_batch_multi`,
             `edit_distances_batch`, `e2e_align_batch`), on any device
  launches   CUDA launches, added by the wrapper where it launches the
             kernel and nowhere else (0 on the CPU, where the dispatch runs
             the plain version)
  cells      DP cells these inputs need: flank (pattern rows) x (text
             length + 1); Viterbi (query length with sentinels) x (real
             edges of the row's HMM); editdist len_a x len_b; e2e (len_p +
             1) x (len_t + 1) for the full-matrix class and, for the band
             class, (len_p + 1) x min(band lanes, len_t + 1) of each pass
  bytes_in   every input of a call read once, as the dispatch takes it
  bytes_out  every output written once (e2e: score, run count and CIGAR
             runs; the direction bits are the kernel's working state)

The classes are `flank`, `viterbi`, `editdist`, `e2e_full` and
`e2e_band`; `totals` folds the two e2e classes into `e2e`. While a device
mesh is installed, `mesh.shard_map` names the shard each of its threads
runs (`on_shard`), and every count is also kept by shard (`by_shard`). The batch entry
points count from the host arrays they upload, so counting waits for no
device. Locked, as the reference's counters are: the pipeline's threads and
the mesh's shard threads dispatch at once.
"""

import contextlib
import threading
from collections import Counter, defaultdict
from typing import Dict, Tuple

import numpy as np

_LOCK = threading.Lock()
_COUNTS: Dict[str, Counter] = defaultdict(Counter)
_BY_SHARD: Dict[Tuple[str, int], Counter] = defaultdict(Counter)
_SHARD = threading.local()

# roofline of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and the
# non-tensor-core fp32 rate, which also stands in for the int32 rate of the
# three integer kernels
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# operations a cell: the recurrence's own adds, compares and selects, no
# index arithmetic. flank: D, diag, N, scan, I, H and four payloads;
# Viterbi: an add and a compare per edge and position; editdist: compare,
# add, two mins, add; e2e: D, diag, N, scan, I, H and the bit packing
OPS_PER_CELL = {"flank": 30, "viterbi": 2, "editdist": 5, "e2e": 14,
                "e2e_full": 14, "e2e_band": 14}


def add(kernel: str, **counts) -> None:
    shard = getattr(_SHARD, "index", None)
    with _LOCK:
        _COUNTS[kernel].update(counts)
        if shard is not None:
            _BY_SHARD[kernel, shard].update(counts)


@contextlib.contextmanager
def on_shard(index: int):
    """Count what this thread adds under mesh shard `index` as well."""
    _SHARD.index = index
    try:
        yield
    finally:
        _SHARD.index = None


def snapshot() -> Dict[str, Dict[str, int]]:
    with _LOCK:
        return {k: dict(v) for k, v in _COUNTS.items()}


def by_shard() -> Dict[int, Dict[str, Dict[str, int]]]:
    """{shard: snapshot} of the counts added under each mesh shard."""
    with _LOCK:
        out: Dict[int, Dict[str, Dict[str, int]]] = {}
        for (kernel, shard), v in sorted(_BY_SHARD.items()):
            out.setdefault(shard, {})[kernel] = dict(v)
        return out


def count(kernel: str, name: str = "launches") -> int:
    with _LOCK:
        return _COUNTS[kernel][name] if kernel in _COUNTS else 0


def clear() -> None:
    with _LOCK:
        _COUNTS.clear()
        _BY_SHARD.clear()


def totals(snap: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """A snapshot by kernel: `e2e` is the sum of its two classes."""
    out = {k: dict(v) for k, v in snap.items()
           if k not in ("e2e_full", "e2e_band")}
    e2e = Counter()
    for k in ("e2e_full", "e2e_band"):
        e2e.update(snap.get(k, {}))
    if e2e:
        out["e2e"] = dict(e2e)
    return out


def operations(kernel: str, counts: Dict[str, int]) -> int:
    return counts.get("cells", 0) * OPS_PER_CELL[kernel]


def bound_ms(kernel: str, counts: Dict[str, int]) -> Tuple[float, str]:
    """The least time the card could take for the counted work: the
    larger of bytes over the HBM rate and operations over the fp32/int32
    rate, and which of the two it is."""
    t_bytes = (counts.get("bytes_in", 0) + counts.get("bytes_out", 0)) \
        / PEAK_BYTES_S * 1e3
    t_ops = operations(kernel, counts) / PEAK_OPS_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pct_peak(kind: str, cells_per_sec: float) -> float:
    """Percent of the card's peak operation rate at a kernel's cell rate."""
    return 100.0 * cells_per_sec * OPS_PER_CELL[kind] / PEAK_OPS_S


def nbytes(*arrays) -> int:
    """Bytes of numpy arrays or tensors, dicts of them included."""
    total = 0
    for a in arrays:
        if isinstance(a, dict):
            total += nbytes(*a.values())
        elif hasattr(a, "element_size"):
            total += a.numel() * a.element_size()
        else:
            total += np.asarray(a).nbytes
    return total


def _ints(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64)


def flank_cells(pattern, lens) -> int:
    """pattern (B, P), 0 in pad rows; lens (B,) text lengths."""
    rows = (np.asarray(pattern) != 0).sum(axis=1).astype(np.int64)
    return int((rows * (_ints(lens) + 1)).sum())


def viterbi_cells(hmms, queries) -> int:
    """Every real in-edge of each row's HMM (duplicates merged, as in the
    kernel's tables) at every position of its query and two sentinels."""
    from .viterbi_tables import hmm_sparse_numpy
    return sum((len(q) + 2) * len(hmm_sparse_numpy(h)["e_src"])
               for h, q in zip(hmms, queries))


def editdist_cells(len_a, len_b) -> int:
    return int((_ints(len_a) * _ints(len_b)).sum())


def e2e_cells(len_p, len_t, band_w=None) -> int:
    """The full matrices' cells, or with `band_w` the band cells of each
    problem that lie inside its matrix's rows."""
    lp, lt = _ints(len_p), _ints(len_t)
    if band_w is None:
        return int(((lp + 1) * (lt + 1)).sum())
    d = lt - lp
    wb = np.abs(d) + 2 * _ints(band_w) + 1
    return int(((lp + 1) * np.minimum(wb, lt + 1)).sum())


def e2e_bytes_in(len_p, len_t) -> int:
    """Both sequences at their true lengths and the two lengths."""
    return int(_ints(len_p).sum() + _ints(len_t).sum()) + 8 * len(len_p)


def e2e_bytes_out(n_runs) -> int:
    """The score, the run count and the CIGAR runs."""
    return 8 * len(n_runs) + 4 * int(_ints(n_runs).sum())
