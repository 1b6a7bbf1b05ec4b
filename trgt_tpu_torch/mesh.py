"""Data parallelism over several devices for the batched kernels
(counterpart of `trgt_tpu/mesh.py`).

Loci are independent, so every batch of kernel problems can be cut along
its batch axis with no exchange between the parts. The mesh is a list of
devices; while one is installed, the four batch entry points
(`flank_align_batch_multi`, `viterbi_batch_multi`, `edit_distances_batch`,
`e2e_align_batch`) cut their problem lists into equal contiguous shards,
one per mesh device, run each shard on its device on a thread of its own
(`shard_map`), and put the results back in input order. With no mesh they
run as they are.

A list may name a device more than once: `[cuda:0, cuda:0]` holds the
split and the reassembly with one card, eight `cpu` entries on the CPU.
Catalog shards (`--shard-index/--shard-count`) are the unit of scaling
across hosts and need nothing here.
"""

import contextlib
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

log = logging.getLogger("trgt")

_MESH: Optional[List["torch.device"]] = None


def visible_devices(kind: str) -> List["torch.device"]:
    """The devices of type `kind` this process sees: every CUDA device, or
    the one CPU."""
    import torch
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no mesh over {kind!r} devices")


def set_mesh(devices: Sequence["torch.device"]) -> Optional[list]:
    """Install an explicit device list (repeats allowed); one device or
    none clears the mesh."""
    global _MESH
    devices = list(devices)
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh of one device type, not {devices}")
    _MESH = devices if len(devices) > 1 else None
    if _MESH is not None:
        log.info("Device mesh enabled: %d-way data parallelism over %s",
                 len(_MESH), sorted({str(d) for d in _MESH}))
    return _MESH


def enable_mesh(n_devices: Optional[int] = None,
                kind: str = "cuda") -> Optional[list]:
    """A mesh over the first n visible devices of type `kind` (all of them
    when n is None); a 1-device request clears the mesh."""
    devices = visible_devices(kind)
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise ValueError(f"mesh over {n} devices but only {len(devices)} "
                         f"{kind} visible")
    return set_mesh(devices[:n])


def disable_mesh() -> None:
    global _MESH
    _MESH = None


def current_mesh() -> Optional[list]:
    return _MESH


def auto_enable(kind: str = "cuda") -> Optional[list]:
    """The mesh of a device run: TRGT_TPU_MESH=0 clears it, TRGT_TPU_MESH=N
    takes the first N visible devices; unset, a mesh the caller installed
    stays and none is made. Unlike trgt_tpu, which takes every visible
    device when unset, a mesh here is asked for: its speed over several
    cards is not measured, and under `-t N` every worker would open a
    context on every card."""
    env = os.environ.get("TRGT_TPU_MESH", "")
    if env == "0":
        disable_mesh()
        return None
    try:
        n = int(env) if env else None
    except ValueError:
        n = None
    if n is None:
        return _MESH
    return enable_mesh(n, kind)


def batch_multiple() -> int:
    """Shards a batch is cut into: the mesh's size, 1 when it is off."""
    return len(_MESH) if _MESH is not None else 1


def shard_bounds(n: int) -> List[tuple]:
    """[(lo, hi)] of the equal contiguous shards of n items, one per mesh
    device (sizes differ by one at most)."""
    m = batch_multiple()
    return [(i * n // m, (i + 1) * n // m) for i in range(m)]


def _on(device):
    if device.type == "cuda":
        import torch
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_map(fn, device, *lists) -> list:
    """fn(*lists, device) with no mesh. With one, fn(*shards, mesh device)
    over each device's contiguous shard of the lists, on one thread per
    shard (the current CUDA device is per thread, and so is the shard
    that telemetry counts under), the results concatenated in input
    order."""
    mesh = _MESH
    if mesh is None:
        return fn(*lists, device)
    if mesh[0].type != device.type:
        raise ValueError(f"a {device.type} call under a mesh of "
                         f"{mesh[0].type} devices")
    from .kernels import telemetry
    parts = [(k, lo, hi, dev) for k, ((lo, hi), dev) in
             enumerate(zip(shard_bounds(len(lists[0])), mesh)) if hi > lo]

    def run(part):
        k, lo, hi, dev = part
        with _on(dev), telemetry.on_shard(k):
            return fn(*(x[lo:hi] for x in lists), dev)

    with ThreadPoolExecutor(max(1, len(parts))) as pool:
        results = list(pool.map(run, parts))
    return [r for part in results for r in part]
