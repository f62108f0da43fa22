"""Multi-process runs over ``torch.distributed`` (the counterpart of the JAX
package's ``jax.distributed.initialize()`` and parallel/mesh.py, less
tensor parallelism).

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

Outside a run every query answers for one process: rank 0 of 1.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = timedelta(minutes=30)

_host_group = None  # the gloo group of the run, set by init_distributed


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
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


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


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place, on the device group; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


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
