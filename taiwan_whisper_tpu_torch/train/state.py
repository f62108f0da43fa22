"""Optimizer, schedules and checkpointing (port of
taiwan_whisper_tpu/train/state.py).

``Optimizer`` is optax's ``adamw`` (scale_by_adam, add_decayed_weights,
scale by the negated schedule) under ``optax.masked`` and, for gradient
accumulation, ``optax.MultiSteps``, written out over dicts of fp32 tensors
keyed by dotted parameter path: the same arithmetic in the same order, so
three steps land on the JAX package's parameters to fp32 rounding. Masked
leaves hold no moments. The state is a plain dict of tensors and ints.

``CheckpointManager`` keeps ``checkpoint-N`` directories with rotation, a
``.keep`` mark for the best checkpoint and resume, in the port's own
``torch.save`` format (``state.pt``); it does not read the JAX package's
orbax checkpoints. In a multi-process run rank 0 alone clears, writes,
marks and rotates, the other ranks wait for it at a named barrier, and
every rank restores. Under tensor parallel each rank holds shards of the
params and of both AdamW moments: ``save`` gathers them over rank 0's
model group first, so the checkpoint holds full tensors, and ``restore``
cuts this rank's shards from them, so a run may resume under another
``--model_parallel`` (as the JAX package's ``restore(like=...)``
re-shards).
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.params import map_params, named_leaves
from ..parallel import mesh, specs

Grads = Dict[str, Optional[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-4
    schedule: str = "constant_with_warmup"  # | linear
    warmup_steps: int = 50
    total_steps: int = 120_000
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    grad_accum_steps: int = 1


def _linear(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    """optax.linear_schedule in fp32 (held at ``init`` when steps <= 0)."""
    def f(count):
        if steps <= 0:
            return np.float32(init)
        frac = np.float32(1) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)
    return f


def make_schedule(cfg: OptimConfig) -> Callable[[int], np.float32]:
    """Learning rate of update ``count`` (0-based): linear warmup from 0,
    then constant or a linear decay to 0 at ``total_steps``."""
    warm = _linear(0.0, cfg.learning_rate, cfg.warmup_steps)
    if cfg.schedule == "constant_with_warmup":
        after = lambda count: np.float32(cfg.learning_rate)  # noqa: E731
    elif cfg.schedule == "linear":
        after = _linear(cfg.learning_rate, 0.0, max(cfg.total_steps - cfg.warmup_steps, 1))
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    return lambda count: warm(count) if count < cfg.warmup_steps else after(
        count - cfg.warmup_steps)


def trainable_mask(params, freeze_encoder: bool = True):
    """Bool tree marking the leaves that train: all but the frozen encoder
    and the decoder positions table, so AdamW holds no moments for them."""
    def trains(path, _):
        if path == "decoder.embed_positions":
            return False
        return not (freeze_encoder and path.startswith("encoder."))
    return map_params(trains, params)


class Optimizer:
    """AdamW with a warmup schedule, optional mask and gradient
    accumulation (``grad_accum_steps`` > 1: mean of the micro-batch
    gradients, one AdamW update every k calls, zero updates between)."""

    def __init__(self, cfg: OptimConfig, mask=None):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.mask = None if mask is None else dict(named_leaves(mask))

    def _in_mask(self, path: str) -> bool:
        return self.mask is None or self.mask[path]

    def init(self, params) -> Dict[str, Any]:
        def zeros():
            return {p: torch.zeros_like(t, dtype=torch.float32)
                    for p, t in named_leaves(params) if self._in_mask(p)}

        adam = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.cfg.grad_accum_steps <= 1:
            return adam
        return {"mini_step": 0, "gradient_step": 0, "acc": {}, "inner": adam}

    def _adamw(self, grads: Grads, state, params) -> Tuple[Grads, Dict[str, Any]]:
        cfg = self.cfg
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        count = state["count"] + 1
        bc1 = np.float32(1) - np.float32(b1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(b2) ** np.float32(count)
        step = -self.schedule(state["count"])
        mu, nu = dict(state["mu"]), dict(state["nu"])
        updates: Grads = {}
        # every leaf with moments updates; a missing gradient is a zero one
        for path, g in {**dict.fromkeys(mu), **grads}.items():
            if not self._in_mask(path):
                updates[path] = g  # optax.masked passes these through
                continue
            if g is None:
                g = torch.zeros_like(mu[path])
            g = g.float()
            mu[path] = (1 - b1) * g + b1 * mu[path]
            nu[path] = (1 - b2) * (g * g) + b2 * nu[path]
            u = (mu[path] / float(bc1)) / (torch.sqrt(nu[path] / float(bc2)) + cfg.adam_eps)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * params[path].float()
            updates[path] = float(step) * u
        return updates, {"count": count, "mu": mu, "nu": nu}

    def update(self, grads: Grads, state, params) -> Tuple[Grads, Dict[str, Any]]:
        """(updates to add to the params, new state). ``grads`` maps paths
        to gradients (None or absent = zero); ``params`` maps paths to the
        current leaves."""
        if self.cfg.grad_accum_steps <= 1:
            return self._adamw(grads, state, params)
        k, n = self.cfg.grad_accum_steps, state["mini_step"]
        acc = dict(state["acc"])
        for path, g in grads.items():
            if g is None and path not in acc:
                continue  # a zero gradient into a zero mean
            a = acc.get(path)
            a = torch.zeros_like(g, dtype=torch.float32) if a is None else a
            g = torch.zeros_like(a) if g is None else g.float()
            acc[path] = a + (g - a) / (n + 1)
        if n < k - 1:
            state = dict(state, mini_step=n + 1, acc=acc)
            return {path: None for path in grads}, state
        mean = {path: acc.get(path) for path in grads}
        updates, inner = self._adamw(mean, state["inner"], params)
        return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                         "acc": {}, "inner": inner}


def make_optimizer(cfg: OptimConfig, mask=None) -> Optimizer:
    """AdamW (+warmup schedule, +grad accumulation); ``mask`` (a bool tree
    from :func:`trainable_mask`) restricts moments to trainable leaves."""
    return Optimizer(cfg, mask)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
_STATE = "state.pt"


def _map_state(fn: Callable[[str, torch.Tensor], torch.Tensor], state: Dict[str, Any]):
    """``fn(param path, tensor)`` over a train state ``{"params": tree,
    "opt_state": ...}``: every leaf of the params tree, and every tensor of
    the optimizer state, each of which sits in a dict keyed by its
    parameter's dotted path (``mu``, ``nu``, ``acc``)."""
    def opt(tree):
        if isinstance(tree, dict):
            return {k: fn(k, v) if isinstance(v, torch.Tensor) else opt(v)
                    for k, v in tree.items()}
        return tree

    return dict(state, params=map_params(fn, state["params"]),
                opt_state=opt(state["opt_state"]))


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


class CheckpointManager:
    """Step-numbered ``torch.save`` checkpoints with rotation and a
    protected best checkpoint (``.keep``)."""

    def __init__(self, directory: str, save_total_limit: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_total_limit = save_total_limit

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name, _STATE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, state: Dict[str, Any],
             keep: bool = False) -> Optional[Dict[str, Any]]:
        """Every rank calls; rank 0 writes. No rank returns before the
        checkpoint is complete and rotated. Returns, on rank 0, the state
        as written (under tensor parallel, full tensors gathered over model
        group 0, on the host, one leaf on the device at a time), and None
        on every other rank."""
        if mesh.model_size() > 1 and mesh.data_rank() == 0:
            # rank 0's model group gathers; rank 0 alone keeps the result
            def gathered(path, t):
                full = specs.gather_leaf(path, t)
                return full.detach().cpu() if mesh.is_main() else None

            state = _map_state(gathered, state)
        path = self._path(step)
        if mesh.is_main():
            if os.path.exists(path):
                # re-saving a step must not demote a protected checkpoint
                keep = keep or os.path.exists(os.path.join(path, ".keep"))
                shutil.rmtree(path)
            os.makedirs(path)
            tmp = os.path.join(path, _STATE + ".tmp")
            torch.save(_detached(state), tmp)
            os.replace(tmp, os.path.join(path, _STATE))
            if keep:
                open(os.path.join(path, ".keep"), "w").close()
            self._rotate()
        mesh.barrier(f"ckpt_done_{step}")
        return state if mesh.is_main() else None

    def _rotate(self):
        if self.save_total_limit is None:
            return
        removable = [s for s in self.all_steps()
                     if not os.path.exists(os.path.join(self._path(s), ".keep"))]
        while len(removable) > self.save_total_limit:
            shutil.rmtree(self._path(removable.pop(0)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None):
        """(state, step) of ``step`` or the latest checkpoint; (None, None)
        when there is none. Under tensor parallel the state holds this
        rank's shards of the checkpoint's full tensors."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        state = torch.load(os.path.join(self._path(step), _STATE),
                           map_location=map_location, weights_only=True)
        if mesh.model_size() > 1:
            state = _map_state(lambda p, t: specs.shard_leaf(p, t, mesh.model_rank(),
                                                            mesh.model_size()), state)
        return state, step
