"""A `genotype -t N` worker run under torch.profiler, for the benchmark's
`--trace 1` runs:

    python gpubench/traced_worker.py <out.npz> '<worker spec as JSON>'

It profiles the device activity of the card the worker takes (card
`worker_index` modulo the visible cards, as `mesh.pool_device` picks),
runs the program's own `engine.worker.worker_main` unchanged, and writes
every device event (name, start on the host's wall clock, duration) and
the worker's allocator peaks to `out.npz`. The first event is a marker
launched at a known host time, which puts the profiler's clock on the
host's.
"""

import json
import sys
import time

import numpy as np


def device_events(prof):
    """(name, start, duration) of every device event, in the profiler's
    own clock (seconds)."""
    from torch.autograd import DeviceType
    try:
        return [(e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9)
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]
    except AttributeError:
        return [(e.name, e.time_range.start * 1e-6,
                 (e.time_range.end - e.time_range.start) * 1e-6)
                for e in prof.events() if e.device_type == DeviceType.CUDA]


def main() -> int:
    out_path, spec = sys.argv[1], json.loads(sys.argv[2])
    from trgt_tpu_torch.engine.worker import worker_main
    if spec["args"]["device"] != "cuda":
        return worker_main(spec)      # no card: nothing to trace
    import torch
    from torch.profiler import ProfilerActivity, profile
    card = torch.device("cuda", spec["worker_index"]
                        % torch.cuda.device_count())
    torch.cuda.set_device(card)
    torch.cuda.synchronize(card)
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    t_mark = time.time()
    torch.zeros(1, device=card)
    torch.cuda.synchronize(card)
    rc = worker_main(spec)
    torch.cuda.synchronize(card)
    prof.stop()
    events = sorted(device_events(prof), key=lambda e: e[1])
    names = sorted({e[0] for e in events})
    index = {n: k for k, n in enumerate(names)}
    shift = t_mark - events[0][1] if events else 0.0
    np.savez(out_path,
             names=np.array(names, dtype=str),
             name=np.array([index[e[0]] for e in events], dtype=np.int32),
             start=np.array([e[1] + shift for e in events]),
             dur=np.array([e[2] for e in events]),
             card=card.index,
             max_reserved=torch.cuda.max_memory_reserved(card),
             max_allocated=torch.cuda.max_memory_allocated(card))
    return rc


if __name__ == "__main__":
    sys.exit(main())
