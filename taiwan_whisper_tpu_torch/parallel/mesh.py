"""Multi-process runs over ``torch.distributed`` (the counterpart of the JAX
package's ``jax.distributed.initialize()`` and parallel/mesh.py).

A run is N processes sharing one filesystem, each started by a launcher
(``torchrun --nproc_per_node N -m taiwan_whisper_tpu_torch.cli ...
--distributed``) that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``. ``init_distributed`` forms two
process groups:

* the default group carries device tensors (NCCL on CUDA, gloo on the
  CPU): the training step's gradient and metric all-reduces. NCCL builds
  its communicator at the first collective, so a run that never reduces a
  device tensor (label, prefilter, evaluate, transcribe) never creates one,
  and two ranks may then share one card;
* a gloo group carries barriers and small host values (the preemption
  flag).

``make_mesh(model)`` lays the run's ranks out as the JAX package's
``(data, model)`` device mesh, ``model`` the minor axis: consecutive ranks
form a model group (tensor parallel: each holds a shard of the weights,
``parallel/specs.py``), and the ranks with the same index in their model
groups form a data group (data parallel: each trains on its slice of the
batch rows). ``all_reduce_sum_`` and ``all_gather`` take the group by name:
``"world"``, ``"data"`` or ``"model"``. Until ``make_mesh`` (and with
``model`` 1) the model group is this rank alone, its collectives are
skipped, and the data group is the world. ``host_local_slice`` stays per
process whatever the mesh: label and prefilter shard files by rank.

Outside a run every query answers for one process: rank 0 of 1.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, List, Optional

import torch
import torch.distributed as dist

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = timedelta(minutes=30)

_host_group = None  # the gloo group of the run, set by init_distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(data, model)`` grid of ranks."""

    data: int = 1  # ranks in a data group (the number of model groups)
    model: int = 1  # ranks in a model group
    data_rank: int = 0  # index of this rank's model group
    model_rank: int = 0  # index of this rank within its model group
    data_group: Any = None  # process group handles (None: the default group)
    model_group: Any = None


_mesh = Mesh()


def launch_env() -> dict:
    """The launcher's variables; raises naming the first one missing."""
    for name in LAUNCH_ENV:
        if not os.environ.get(name):
            raise RuntimeError(
                f"--distributed needs the launcher's environment: {name} is not set "
                f"(run under torchrun, or set {', '.join(LAUNCH_ENV)})")
    return {name: os.environ[name] for name in LAUNCH_ENV}


def init_distributed(device=None) -> torch.device:
    """Join the run the launcher's environment describes and return this
    rank's device: ``cuda:<LOCAL_RANK>`` unless ``device`` names another
    (``cpu``: gloo for every group). On CUDA the rank's card becomes the
    current device, since the kernels launch on the current device."""
    global _host_group
    env = launch_env()
    local_rank = int(env["LOCAL_RANK"])
    dev = torch.device(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank} names no CUDA device "
                               f"({torch.cuda.device_count()} visible)")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
                            timeout=TIMEOUT)
    _host_group = dist.new_group(backend="gloo", timeout=TIMEOUT)
    return dev


def shutdown():
    """Leave the run (no-op outside one)."""
    global _host_group, _mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None
    _mesh = Mesh()


def make_mesh(model: int = 1) -> Mesh:
    """Lay the run's ranks out as a ``(data, model)`` grid of ``model``
    ranks to a model group and the world's other factor to a data group
    (JAX's ``make_mesh(data=-1, model=model)``), and make it this process's
    mesh; every rank calls it, with the same argument. Rank r sits in model
    group ``r // model`` at index ``r % model``. Raises ``ValueError`` when
    ``model`` does not divide the world."""
    global _mesh
    world = world_size()
    model = max(model, 1)
    if world % model:
        raise ValueError(f"{world} processes do not divide by --model_parallel {model}")
    data = world // model
    me = rank()
    model_group = data_group = None
    if model > 1:
        # every rank creates every group, in the same order
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)], timeout=TIMEOUT)
            if me // model == d:
                model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)], timeout=TIMEOUT)
            if me % model == m:
                data_group = g
    _mesh = Mesh(data=data, model=model, data_rank=me // model, model_rank=me % model,
                 data_group=data_group, model_group=model_group)
    return _mesh


def model_size() -> int:
    return _mesh.model


def model_rank() -> int:
    return _mesh.model_rank


def data_size() -> int:
    return _mesh.data if _mesh.model > 1 else world_size()


def data_rank() -> int:
    return _mesh.data_rank if _mesh.model > 1 else rank()


def _group(name: str):
    """(group handle, skip): the named group, and whether it holds this
    rank alone so that its collectives are no-ops."""
    if name == "world":
        return None, False
    if name == "model":
        return _mesh.model_group, _mesh.model == 1
    if name == "data":
        # a model size of 1 keeps the data group the world, as before
        # make_mesh, so a world-1 run still reduces through it
        if _mesh.model == 1:
            return None, False
        return _mesh.data_group, _mesh.data == 1
    raise ValueError(f"no process group named {name!r}")


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier(name: str):
    """Wait until every rank reaches the barrier of the same ``name``;
    raises when ranks meet at barriers of different names (as JAX's
    ``sync_global_devices`` does). No-op outside a run."""
    if not initialized():
        return
    names: List[Optional[str]] = [None] * world_size()
    dist.all_gather_object(names, name, group=_host_group)
    if len(set(names)) != 1:
        raise RuntimeError(f"ranks met at different barriers: {names}")


def any_rank(flag: bool) -> bool:
    """True when ``flag`` is set on any rank (the flag itself outside a
    run)."""
    if not initialized():
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group)
    return bool(t.item())


def all_reduce_sum_(t: torch.Tensor, group: str = "world") -> torch.Tensor:
    """Sum ``t`` in place over the ranks of the named device group
    (``"world"``, ``"data"`` or ``"model"``); returns it. A group of this
    rank alone leaves ``t`` as it is."""
    handle, alone = _group(group)
    if not alone:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=handle)
    return t


def all_gather(t: torch.Tensor, group: str) -> List[torch.Tensor]:
    """``t`` of every rank of the named device group, in rank order."""
    handle, alone = _group(group)
    if alone:
        return [t]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(handle))]
    dist.all_gather(out, t, group=handle)
    return out


def host_local_slice(n_items: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> slice:
    """The contiguous shard of ``n_items`` this process owns: the first
    ``n_items % count`` ranks take one more. ``process_index`` /
    ``process_count`` override the run's rank and size."""
    pid = rank() if process_index is None else process_index
    nproc = world_size() if process_count is None else process_count
    per = n_items // nproc
    extra = n_items % nproc
    start = pid * per + min(pid, extra)
    return slice(start, start + per + (1 if pid < extra else 0))
