"""The tensor-parallel layout of the weights (port of
taiwan_whisper_tpu/parallel/specs.py): which dim of each leaf splits over
the ``model`` group of ``parallel/mesh.py``, and the cuts and gathers that
go between a full weights tree and one model rank's shard of it.

The rules are the JAX package's, Megatron-style: the q/k/v projections of
self- and cross-attention and ``fc1`` split by output columns (a rank
holds whole heads and a slice of the MLP), ``out`` and ``fc2`` by input
rows (their biases replicated, added once after the sum over the group),
and everything else is replicated: the norms, the convs, the positions
tables and ``embed_tokens`` (51865 = 5 x 11 x 23 x 41 divides by no
practical group size; the logits stay whole on every rank). The port's
dense weights are ``[d_out, d_in]`` (JAX: ``[d_in, d_out]``) and its
layers a list, so JAX's column split ``P(None, model)`` of a kernel is
dim 0 here and its row split ``P(model, None)`` dim 1.

Unlike JAX, whose GSPMD pads an uneven split, a split that does not
divide raises ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.config import WhisperConfig
from ..models.params import map_params
from . import mesh

Params = Dict[str, Any]

# (dotted path suffix) -> split dim of the leaf
_RULES = (
    *((f"{attn}.{proj}.{leaf}", 0) for attn in ("self_attn", "cross_attn")
      for proj in ("q", "k", "v") for leaf in ("weight", "bias")),
    ("self_attn.out.weight", 1),
    ("cross_attn.out.weight", 1),
    ("fc1.weight", 0),
    ("fc1.bias", 0),
    ("fc2.weight", 1),
)


def split_dim(path: str) -> Optional[int]:
    """The dim of leaf ``path`` split over the model group, or None when
    the leaf is replicated."""
    for suffix, dim in _RULES:
        if path == suffix or path.endswith("." + suffix):
            return dim
    return None


def check_divisible(config: WhisperConfig, size: int):
    """Raise ``ValueError`` unless every split of ``config`` divides by
    ``size``: the attention heads, ``d_model`` and ``ffn_dim``."""
    for name in ("encoder_attention_heads", "decoder_attention_heads", "d_model", "ffn_dim"):
        n = getattr(config, name)
        if n % size:
            raise ValueError(f"--model_parallel {size} does not divide {name} {n}")


def shard_leaf(path: str, t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Model rank ``rank``'s contiguous shard of the full leaf ``t`` (a
    copy; the leaf itself when replicated or ``size`` is 1)."""
    dim = split_dim(path)
    if dim is None or size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"{path}: dim {dim} of {tuple(t.shape)} does not divide by {size}")
    return t.chunk(size, dim)[rank].clone()


def shard_params(params: Params, rank: int, size: int,
                 config: Optional[WhisperConfig] = None) -> Params:
    """Model rank ``rank`` of ``size``'s shard of a full weights tree (or
    of any subtree that keeps the dotted paths, such as a decoder alone).
    With ``config``, first checks that its heads and widths divide."""
    if config is not None:
        check_divisible(config, size)
    return map_params(lambda path, t: shard_leaf(path, t, rank, size), params)


def gather_leaf(path: str, t: torch.Tensor) -> torch.Tensor:
    """The full leaf from this rank's shard ``t``: the shards of the model
    group concatenated along the split dim (every rank of the group calls;
    the leaf itself when replicated or the group is one rank)."""
    dim = split_dim(path)
    if dim is None or mesh.model_size() == 1:
        return t
    return torch.cat(mesh.all_gather(t.detach().contiguous(), "model"), dim)
