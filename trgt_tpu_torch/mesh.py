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

A device run in one process meshes over every visible card by default,
as trgt_tpu meshes over every visible chip (`auto_enable`). The workers of
`-t N` do not: each takes one card, round-robin (`pool_device`), so that a
worker opens one CUDA context and runs its small batches whole. A list may
name a device more than once: `[cuda:0, cuda:0]` holds the split and the
reassembly with one card, eight `cpu` entries on the CPU.

Catalog shards (`--shard-index/--shard-count`) are the unit of scaling
across hosts. With TRGT_COORDINATOR_ADDRESS set, the shard processes join
one `torch.distributed` group (`initialize_distributed`). The shards
exchange nothing, so the group is only their rendezvous: it runs on gloo,
which also lets two ranks share one card, and each process meshes over its
own cards.
"""

import contextlib
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

log = logging.getLogger("trgt")

# seconds a shard waits for its peers to join the group:
# jax.distributed.initialize's default
DISTRIBUTED_TIMEOUT_S = 300
# seconds a shard waits at its end for its peers to finish theirs: shards of
# a genome-wide catalog take hours, and hosts differ in speed
EXIT_TIMEOUT_S = 48 * 3600

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
    when n is None); a request for one device or fewer clears the mesh."""
    devices = visible_devices(kind)
    n = len(devices) if n_devices is None else n_devices
    if n <= 1:
        disable_mesh()
        return None
    if n > len(devices):
        raise ValueError(f"mesh over {n} devices but only {len(devices)} "
                         f"{kind} visible")
    return set_mesh(devices[:n])


def disable_mesh() -> None:
    global _MESH
    _MESH = None


def current_mesh() -> Optional[list]:
    return _MESH


def _requested() -> Optional[int]:
    """The mesh size TRGT_TPU_MESH asks for; None when it is unset or not a
    number."""
    try:
        return int(os.environ.get("TRGT_TPU_MESH", ""))
    except ValueError:
        return None


def auto_enable(kind: str = "cuda") -> Optional[list]:
    """The mesh of a device run, as trgt_tpu makes it: TRGT_TPU_MESH=0
    clears it, TRGT_TPU_MESH=N takes the first N visible devices of type
    `kind`; unset, every visible device when there are several, and none
    with one. Unset, a mesh of `kind` already installed stays, on any
    number of cards (trgt_tpu keeps one only over one device): the caller's
    `[cuda:0, cuda:0]` of `engine/sharding.py dryrun`, or an earlier run's.
    A mesh of another type is dropped: no call of this run could use it."""
    n = _requested()
    if n == 0:
        disable_mesh()
        return None
    if n is None:
        if _MESH is not None and _MESH[0].type == kind:
            return _MESH
        disable_mesh()
        if len(visible_devices(kind)) <= 1:
            return None
    return enable_mesh(n, kind)


def pool_device(device: "torch.device",
                worker_index: int) -> "torch.device":
    """The device of `-t N` worker `worker_index`. With TRGT_TPU_MESH unset
    and several visible cards, the worker takes card `worker_index` modulo
    their number and no mesh: trgt_tpu meshes every worker over every chip,
    but here each worker would then open a context on every card and cut its
    small batches across them. Otherwise `device`, under `auto_enable`'s
    mesh."""
    cards = visible_devices(device.type)
    if _requested() is None and len(cards) > 1:
        import torch
        disable_mesh()
        card = cards[worker_index % len(cards)]
        torch.cuda.set_device(card)
        return card
    auto_enable(device.type)
    return device


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
    """fn(*lists, device) on `device` with no mesh (a pool worker's card
    need not be the pipeline threads' current device). With a mesh,
    fn(*shards, mesh device)
    over each device's contiguous shard of the lists, on one thread per
    shard (the current CUDA device is per thread, and so is the shard
    that telemetry counts under), the results concatenated in input
    order."""
    mesh = _MESH
    if mesh is None:
        with _on(device):
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


def initialize_distributed(shard_index: int, shard_count: int,
                           kind: str = "cuda") -> None:
    """Join the catalog cluster (counterpart of trgt_tpu's
    `initialize_distributed`): with TRGT_COORDINATOR_ADDRESS (host:port)
    set, shard `shard_index` of `shard_count` joins one gloo group as rank
    `shard_index`, rank 0 serving the rendezvous at that address. A rank
    whose peers do not come within DISTRIBUTED_TIMEOUT_S raises: a shard
    given an address never runs standalone. Without the address the shard
    runs standalone."""
    coordinator = os.environ.get("TRGT_COORDINATOR_ADDRESS")
    if not coordinator:
        log.info("Shard %d/%d running standalone (set "
                 "TRGT_COORDINATOR_ADDRESS for a multi-process mesh)",
                 shard_index, shard_count)
        return
    import datetime
    import torch.distributed as dist
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator}",
        world_size=shard_count, rank=shard_index,
        timeout=datetime.timedelta(seconds=DISTRIBUTED_TIMEOUT_S))
    log.info("torch.distributed initialized: process %d/%d, %d local %s "
             "devices", dist.get_rank(), dist.get_world_size(),
             len(visible_devices(kind)), kind)


def shutdown_distributed() -> None:
    """Leave the catalog cluster, if this process joined one: wait up to
    EXIT_TIMEOUT_S for every rank to finish its shard (rank 0 serves the
    rendezvous store, so it must not leave before the others), then destroy
    the group. This shard's outputs are complete by then, so a peer that
    failed or never came is logged, not raised."""
    import datetime
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        return
    try:
        # its own timeout: a plain barrier waits only DISTRIBUTED_TIMEOUT_S
        dist.monitored_barrier(
            timeout=datetime.timedelta(seconds=EXIT_TIMEOUT_S))
    except RuntimeError as e:
        log.warning("Catalog cluster: leaving before every peer finished "
                    "(%s); this shard's outputs are complete", e)
    dist.destroy_process_group()
    log.info("torch.distributed shut down")
