"""Device mesh and sharding layout, the counterpart of
``supertonic_tpu.parallel.mesh``.

The JAX mesh is single-controller inside one process: GSPMD shards the
batch over the ``data`` axis and the Megatron weights over ``model`` and
inserts the collectives. The port keeps that split in one process:

  * ``Mesh`` is a [data, model] array of ``torch.device``. A device may
    repeat (``[cuda:0, cuda:0]``, ``["cpu"] * 8``): the sharding logic and
    the kernels then run at their sharded shapes on one device.
  * ``data`` axis: each data row holds a replica of the params
    (``shard_params``) and takes its slice of every batch
    (``shard_batch``); the engine runs the rows one after another on the
    host without waiting for any of them and gathers their outputs in row
    order.
  * ``model`` axis: within a row, the column-parallel linears (QKV,
    FFN-in) and the row-parallel ones (O, FFN-out) hold only their rank's
    slice on the rank's device (``layers.ShardedLinear``); the layers sum
    the row-parallel partials across the group before the bias. Everything
    else lives on the row's lead device, ``devices[d, 0]``.

Multi-process entry is ``initialize_distributed``: a ``torch.distributed``
group over TCP that carries control only (``parallel/multihost.py``); no
tensor of the request path crosses it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a [data, model] object array of ``torch.device``."""

    devices: np.ndarray
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def row(self, d: int) -> list[torch.device]:
        """The model group of data row ``d`` (its lead device first)."""
        return list(self.devices[d])

    @property
    def leads(self) -> list[torch.device]:
        """Each data row's lead device, in row order."""
        return [self.devices[d, 0] for d in range(self.devices.shape[0])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, *, model_parallel: int = 1,
              devices=None) -> Mesh:
    """2-D mesh (data, model). ``model_parallel=1`` = pure DP (default).
    ``devices`` defaults to every CUDA device (``cuda:0..n-1``) and raises
    without a card; it may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(e.g. ['cpu'] * 8) to build a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_as_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or model_parallel < 1:
        raise ValueError(f"a mesh needs devices and model >= 1, got {n} and "
                         f"model={model_parallel}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model={model_parallel}")
    arr = np.empty((n // model_parallel, model_parallel), dtype=object)
    for i, d in enumerate(devices):
        arr[i // model_parallel, i % model_parallel] = d
    return Mesh(arr)


def initialize_distributed(**kwargs) -> None:
    """Multi-process runtime init: a ``torch.distributed`` gloo group over
    TCP, for control only.

    Config is the kwargs (``coordinator_address`` "host:port",
    ``num_processes``, ``process_id``, optional ``initialization_timeout``
    seconds, the ``jax.distributed.initialize`` names) or torch's
    ``MASTER_ADDR`` environment (with ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``). An explicit config must succeed: a misconfigured
    coordinator raises within its timeout, never degrades to
    single-process serving. Without any config this is a no-op, and so is
    a second call once the group is up."""
    import datetime
    import os

    configured = bool(kwargs) or bool(os.environ.get("MASTER_ADDR"))
    if not configured:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=float(kwargs.pop("initialization_timeout", 300)))
    if kwargs:
        init = dict(init_method=f"tcp://{kwargs.pop('coordinator_address')}",
                    world_size=int(kwargs.pop("num_processes")),
                    rank=int(kwargs.pop("process_id")))
        if kwargs:
            raise TypeError(f"unexpected arguments {sorted(kwargs)}")
    else:
        init = dict(init_method="env://")
    try:
        dist.init_process_group("gloo", timeout=timeout, **init)
    except Exception as e:
        from ..utils.logging import default_logger as log

        log.error("torch_distributed_init_failed", error=f"{type(e).__name__}: {e}")
        raise


# ---------------------------------------------------------------------------
# parameter shardings (tensor parallelism)
# ---------------------------------------------------------------------------

def _pspec_for_path(path: tuple[str, ...]) -> tuple:
    """Megatron-style TP layout: column-parallel QKV/FFN-in, row-parallel
    O/FFN-out; everything else replicated. The JAX ``PartitionSpec`` as a
    plain tuple."""
    if len(path) >= 3:
        parent, leaf = path[-3], path[-2]
        name = path[-1]
        # int8-quantized linears (models.quantize_params): "w_q" shards like
        # "w"; the per-output-channel "w_scale" shards like the bias.
        if parent == "ffn" and leaf == "in":
            return (None, MODEL_AXIS) if name in ("w", "w_q") else (MODEL_AXIS,)
        if parent == "ffn" and leaf == "out":
            return (MODEL_AXIS, None) if name in ("w", "w_q") else ()
        if parent in ("self", "cross") and leaf in ("q", "k", "v"):
            return (None, MODEL_AXIS) if name in ("w", "w_q") else (MODEL_AXIS,)
        if parent in ("self", "cross") and leaf == "o":
            return (MODEL_AXIS, None) if name in ("w", "w_q") else ()
    return ()


def _walk_pspecs(tree: Any, path: tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _walk_pspecs(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk_pspecs(v, path + (str(i),)) for i, v in enumerate(tree)]
    return _pspec_for_path(path)


def param_pspecs(params: Any) -> Any:
    """Partition-spec tree matching ``params`` (TP layout on the model axis)."""
    return _walk_pspecs(params)


def check_tensor_parallel(cfg, model: int) -> None:
    """A rank's attention kernel runs whole heads and its FFN whole hidden
    columns: every transformer network's ``n_heads`` and FFN width must
    divide by ``model``. (GSPMD would split a head across ranks.)"""
    if model <= 1:
        return
    for name in ("duration_predictor", "text_encoder", "vector_estimator"):
        hp = getattr(cfg, name)
        ffn = hp.dim * hp.ffn_mult
        if hp.n_heads % model or ffn % model:
            raise ValueError(
                f"{name}: n_heads={hp.n_heads} and FFN width {ffn} must divide "
                f"by the model axis ({model}); a rank runs whole heads")


def _slice(a, spec: tuple, rank: int, ranks: int):
    """Rank ``rank``'s slice of array ``a`` along the axis ``spec`` names."""
    axis = spec.index(MODEL_AXIS)
    n = a.shape[axis]
    if n % ranks:
        raise ValueError(f"dim {axis} of size {n} does not divide by model={ranks}")
    step = n // ranks
    return np.take(a, np.arange(rank * step, (rank + 1) * step), axis=axis)


_LINEAR_KEYS = ({"w", "b"}, {"w_q", "w_scale", "b"})


def _shard_row(tree, path: tuple, group: list, dtype):
    """One data row's module tree: replicated nodes on the group's lead
    device, each sharded linear as a ``ShardedLinear`` of its ranks'
    slices on their devices."""
    from ..models import layers as L
    from ..models import load_params

    if isinstance(tree, (list, tuple)):
        return torch.nn.ModuleList([_shard_row(v, path + (str(i),), group, dtype)
                                    for i, v in enumerate(tree)])
    if set(tree) in _LINEAR_KEYS:
        if path[-1] in ("qkv", "kv"):
            # models.fuse_projections: the heads of q, k and v interleave
            # across the fused columns, so no column slice is a rank's heads
            raise ValueError(f"{'/'.join(path)}: fused projections cannot be "
                             f"sharded over a model axis; pass the unfused tree")
        specs = {k: _pspec_for_path(path + (k,)) for k in tree}
        if any(specs.values()):
            split = "col" if specs["b"] else "row"
            shards = []
            for r, dev in enumerate(group):
                part = {k: (_slice(np.asarray(v), specs[k], r, len(group))
                            if specs[k] else np.asarray(v)) for k, v in tree.items()}
                shards.append(load_params(part, device=dev, dtype=dtype))
            return L.ShardedLinear(shards, split)
    if any(isinstance(v, (dict, list, tuple)) for v in tree.values()):
        return torch.nn.ModuleDict({k: _shard_row(v, path + (k,), group, dtype)
                                    for k, v in tree.items()})
    return load_params(tree, device=group[0], dtype=dtype)


def shard_params(params: Any, mesh: Mesh, *, dtype=torch.float32) -> list:
    """The param tree placed on the mesh: one replica per data row, in row
    order. ``params`` is the JAX-layout numpy tree (``models.load_params``
    builds each replica, with its torch layouts and ``dtype``); with
    ``model`` > 1 each rank of a row holds only its slice of the sharded
    leaves (``param_pspecs``). A tree of tensors (a graph backend's
    weights, whose names are all replicated) is copied to each row's lead
    device."""
    from ..models import load_params

    out = []
    for d in range(mesh.devices.shape[0]):
        group = mesh.row(d)
        if _holds_tensors(params):
            out.append(_to_device(params, group[0]))
        elif len(group) == 1:
            out.append(load_params(params, device=group[0], dtype=dtype))
        else:
            out.append(_shard_row(params, (), group, dtype))
    return out


def _holds_tensors(tree) -> bool:
    if isinstance(tree, dict):
        return any(_holds_tensors(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds_tensors(v) for v in tree)
    return isinstance(tree, torch.Tensor)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# activation/input shardings (data parallelism over the batch dim)
# ---------------------------------------------------------------------------

def batch_sharding(mesh: Mesh, ndim: int) -> tuple:
    """The partition spec of a batch-major array: dim 0 over the data
    axis, the others whole (the JAX ``P(DATA_AXIS, None, ...)``)."""
    del mesh
    return (DATA_AXIS,) + (None,) * (ndim - 1)


def shard_batch(mesh: Mesh, *arrays):
    """Split each array's dim 0 over the data rows: per array, a list of
    row slices (numpy arrays become tensors of their dtype), each on its
    row's lead device. The batch must divide by the data axis."""
    leads = mesh.leads
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % len(leads):
            raise ValueError(f"batch {t.shape[0]} does not divide by the data "
                             f"axis ({len(leads)})")
        out.append([part.to(dev) for part, dev in zip(t.chunk(len(leads)), leads)])
    return tuple(out) if len(out) > 1 else out[0]


def pad_batch_to_multiple(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)
