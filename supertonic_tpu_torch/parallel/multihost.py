"""Multi-host serving topology, the counterpart of
``supertonic_tpu.parallel.multihost``.

One engine process per host over its local devices: no cross-host
collectives in the request path. A ``torch.distributed`` group over TCP
carries control only (bring-up, rank, world size, the device counts), so
it runs on gloo on every machine; any model-axis collective stays inside a
host's mesh (``parallel/mesh.py``). The helpers here give each host its
slice of a request stream and its local mesh.
"""

from __future__ import annotations

import torch

from .mesh import initialize_distributed, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, **kwargs) -> None:
    """Join the control group at ``coordinator_address`` ("host:port").
    No-op without coordinator config (kwargs or ``MASTER_ADDR``); with
    one, failures are raised (a 2-host deployment silently serving
    single-host is worse than crashing). ``kwargs``: e.g.
    ``initialization_timeout`` seconds."""
    if coordinator_address:
        kwargs = dict(kwargs, coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    initialize_distributed(**kwargs)


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    dist = _group()
    return 0 if dist is None else dist.get_rank()


def world_size() -> int:
    dist = _group()
    return 1 if dist is None else dist.get_world_size()


def local_device_count() -> int:
    return torch.cuda.device_count()


def device_counts(local: int | None = None) -> list[int]:
    """Every process's local device count, in rank order (gathered over the
    control group; this process's alone without one)."""
    local = local_device_count() if local is None else int(local)
    dist = _group()
    if dist is None:
        return [local]
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, local)
    return [int(n) for n in out]


def local_mesh(model_parallel: int = 1, *, devices=None):
    """Mesh over THIS host's devices only (per-host engine pattern): its
    CUDA devices by default, which raises without a card."""
    return make_mesh(model_parallel=model_parallel, devices=devices)


def host_shard(items: list, process_id: int | None = None,
               process_count: int | None = None) -> list:
    """Deterministic round-robin slice of a request list for this host."""
    pid = process_index() if process_id is None else process_id
    pcount = world_size() if process_count is None else process_count
    return items[pid::pcount]


def is_egress_host(process_id: int | None = None) -> bool:
    """Single designated egress host (process 0) for aggregated responses —
    per-request waveforms leave from the host that synthesized them."""
    pid = process_index() if process_id is None else process_id
    return pid == 0
