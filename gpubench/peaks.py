"""The yardstick of the kernels: one H100 SXM's published peaks
(NVIDIA's data sheet, at its 700 W limit) and the operations each DP
cell of a kernel class costs. The program's counters
(`trgt_tpu_torch.kernels.telemetry`) give the cells and bytes; the least
time they could take is worked out here.

The three integer kernels have no published int32 rate outside the
tensor cores; the fp32 rate stands in for it (an assumption).
"""

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# the recurrence's own adds, compares and selects a cell, no index
# arithmetic. flank: D, diag, N, scan, I, H and four payloads; Viterbi:
# an add and a compare per edge and position; editdist: compare, add,
# two mins, add; e2e: D, diag, N, scan, I, H and the bit packing
OPS_PER_CELL = {"flank": 30, "viterbi": 2, "editdist": 5,
                "e2e_full": 14, "e2e_band": 14}


def bound_s(kernel: str, counts: dict) -> float:
    """The larger of the bytes over the HBM rate (inputs read once,
    outputs written once) and the operations over the fp32 rate."""
    t_bytes = (counts.get("bytes_in", 0) + counts.get("bytes_out", 0)) \
        / PEAK_BYTES_S
    t_ops = counts.get("cells", 0) * OPS_PER_CELL[kernel] / PEAK_OPS_S
    return max(t_bytes, t_ops)
