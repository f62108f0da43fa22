"""The port's weights: layout, random init, and the bridges in.

Weights are a nested dict of tensors in PyTorch's own layouts, which are
also HF's: dense weights ``[d_out, d_in]`` (``F.linear``), conv weights
``[C_out, C_in, K]`` (``F.conv1d``), one dict per layer in a list::

    {"encoder": {"conv1": {"weight", "bias"}, "conv2": ..., "embed_positions",
                 "layers": [{"self_attn": {"q", "k", "v", "out"},
                             "self_attn_ln", "fc1", "fc2", "final_ln"}, ...],
                 "ln_post"},
     "decoder": {"embed_tokens", "embed_positions",
                 "layers": [{... , "cross_attn", "cross_attn_ln"}, ...],
                 "ln_post"}}

Each linear is ``{"weight"[, "bias"]}`` (the self/cross ``k`` projections
carry no bias) and each LayerNorm is ``{"weight", "bias"}``.

``from_jax_params`` takes the JAX package's pytree (stacked layers, dense
kernels ``[d_in, d_out]``, conv kernels ``[K, C_in, C_out]``) as numpy
arrays; ``load_hf_state_dict`` takes HF names. ``prepare_params`` casts
once, at load, for inference, to the policy's compute dtype on the target
device: matmul weights and embeddings to the compute dtype, LayerNorm
scale and bias kept fp32 (the model casts per call, as the JAX package
does, and the casts of prepared weights are no-ops; eager PyTorch would
otherwise recast every weight on every decode step). Training keeps fp32
masters and lets the model cast them inside the autograd graph.
``init_student_from_teacher`` and ``mix_language_embeddings`` build
students; ``map_params``/``named_leaves`` walk the tree by dotted path.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import DtypePolicy, WhisperConfig

Params = Dict[str, Any]

_ATTN = ("q", "k", "v", "out")
_HF_ATTN = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj"}


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal table (encoder positions)."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


# ---------------------------------------------------------------------------
# random init
# ---------------------------------------------------------------------------

def init_params(config: WhisperConfig, seed: int = 0, *, device="cpu",
                dtype=torch.float32) -> Params:
    """Seeded random weights, made directly on ``device`` from a
    ``torch.Generator`` (the JAX package's init draws other numbers from
    the same seed; tests that compare the two bridge JAX's weights in with
    ``from_jax_params``). Std 0.02 normals, zero biases, unit LayerNorms,
    sinusoidal encoder positions."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f = config.d_model, config.ffn_dim

    def normal(*shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    def dense(d_in, d_out, bias=True):
        p = {"weight": normal(d_out, d_in)}
        if bias:
            p["bias"] = zeros(d_out)
        return p

    def ln():
        return {"weight": torch.ones(d, device=device, dtype=dtype), "bias": zeros(d)}

    def attn():
        return {"q": dense(d, d), "k": dense(d, d, bias=False),
                "v": dense(d, d), "out": dense(d, d)}

    def layer(cross):
        p = {"self_attn": attn(), "self_attn_ln": ln(),
             "fc1": dense(d, f), "fc2": dense(f, d), "final_ln": ln()}
        if cross:
            p["cross_attn"] = attn()
            p["cross_attn_ln"] = ln()
        return p

    return {
        "encoder": {
            "conv1": {"weight": normal(d, config.num_mel_bins, 3), "bias": zeros(d)},
            "conv2": {"weight": normal(d, d, 3), "bias": zeros(d)},
            "embed_positions": torch.from_numpy(
                sinusoids(config.max_source_positions, d)).to(device, dtype),
            "layers": [layer(False) for _ in range(config.encoder_layers)],
            "ln_post": ln(),
        },
        "decoder": {
            "embed_tokens": normal(config.vocab_size, d),
            "embed_positions": normal(config.max_target_positions, d),
            "layers": [layer(True) for _ in range(config.decoder_layers)],
            "ln_post": ln(),
        },
    }


# ---------------------------------------------------------------------------
# bridges
# ---------------------------------------------------------------------------

def from_jax_params(tree: Mapping[str, Any], config: WhisperConfig) -> Params:
    """The JAX package's params pytree (numpy or array-like leaves) -> the
    port's weights (fp32 CPU tensors, PyTorch layouts)."""

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def dense(p, i=None):
        k = np.asarray(p["kernel"])
        out = {"weight": t((k if i is None else k[i]).T)}
        if "bias" in p:
            b = np.asarray(p["bias"])
            out["bias"] = t(b if i is None else b[i])
        return out

    def ln(p, i=None):
        s, b = np.asarray(p["scale"]), np.asarray(p["bias"])
        return {"weight": t(s if i is None else s[i]), "bias": t(b if i is None else b[i])}

    def layer(lp, i, cross):
        out = {
            "self_attn": {n: dense(lp["self_attn"][n], i) for n in _ATTN},
            "self_attn_ln": ln(lp["self_attn_ln"], i),
            "fc1": dense(lp["fc1"], i),
            "fc2": dense(lp["fc2"], i),
            "final_ln": ln(lp["final_ln"], i),
        }
        if cross:
            out["cross_attn"] = {n: dense(lp["cross_attn"][n], i) for n in _ATTN}
            out["cross_attn_ln"] = ln(lp["cross_attn_ln"], i)
        return out

    def conv(p):
        return {"weight": t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0))),
                "bias": t(p["bias"])}

    enc, dec = tree["encoder"], tree["decoder"]
    return {
        "encoder": {
            "conv1": conv(enc["conv1"]),
            "conv2": conv(enc["conv2"]),
            "embed_positions": t(enc["embed_positions"]),
            "layers": [layer(enc["layers"], i, False)
                       for i in range(config.encoder_layers)],
            "ln_post": ln(enc["ln_post"]),
        },
        "decoder": {
            "embed_tokens": t(dec["embed_tokens"]),
            "embed_positions": t(dec["embed_positions"]),
            "layers": [layer(dec["layers"], i, True)
                       for i in range(config.decoder_layers)],
            "ln_post": ln(dec["ln_post"]),
        },
    }


def load_hf_state_dict(state_dict: Mapping[str, Any], config: WhisperConfig) -> Params:
    """An HF ``WhisperForConditionalGeneration`` state dict (torch tensors or
    numpy arrays; keys with or without the ``model.`` prefix) -> weights.
    Tensors keep their stored dtype; ``prepare_params`` casts."""
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("model."):
            k = k[len("model."):]
        sd[k] = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    if "proj_out.weight" in sd and "decoder.embed_tokens.weight" not in sd:
        sd["decoder.embed_tokens.weight"] = sd["proj_out.weight"]

    def dense(prefix):
        p = {"weight": sd[f"{prefix}.weight"]}
        if f"{prefix}.bias" in sd:
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    def ln(prefix):
        return {"weight": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def attn(prefix):
        return {ours: dense(f"{prefix}.{theirs}") for ours, theirs in _HF_ATTN.items()}

    def layer(prefix, cross):
        p = {
            "self_attn": attn(f"{prefix}.self_attn"),
            "self_attn_ln": ln(f"{prefix}.self_attn_layer_norm"),
            "fc1": dense(f"{prefix}.fc1"),
            "fc2": dense(f"{prefix}.fc2"),
            "final_ln": ln(f"{prefix}.final_layer_norm"),
        }
        if cross:
            p["cross_attn"] = attn(f"{prefix}.encoder_attn")
            p["cross_attn_ln"] = ln(f"{prefix}.encoder_attn_layer_norm")
        return p

    return {
        "encoder": {
            "conv1": dense("encoder.conv1"),
            "conv2": dense("encoder.conv2"),
            "embed_positions": sd["encoder.embed_positions.weight"],
            "layers": [layer(f"encoder.layers.{i}", False)
                       for i in range(config.encoder_layers)],
            "ln_post": ln("encoder.layer_norm"),
        },
        "decoder": {
            "embed_tokens": sd["decoder.embed_tokens.weight"],
            "embed_positions": sd["decoder.embed_positions.weight"],
            "layers": [layer(f"decoder.layers.{i}", True)
                       for i in range(config.decoder_layers)],
            "ln_post": ln("decoder.layer_norm"),
        },
    }


def to_hf_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """Inverse of ``load_hf_state_dict`` (``model.``-prefixed HF names; the
    tied ``proj_out`` is omitted, as HF checkpoints do)."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, p):
        for k, v in p.items():
            out[f"{prefix}.{k}"] = v

    enc, dec = params["encoder"], params["decoder"]
    put("model.encoder.conv1", enc["conv1"])
    put("model.encoder.conv2", enc["conv2"])
    out["model.encoder.embed_positions.weight"] = enc["embed_positions"]
    put("model.encoder.layer_norm", enc["ln_post"])
    out["model.decoder.embed_tokens.weight"] = dec["embed_tokens"]
    out["model.decoder.embed_positions.weight"] = dec["embed_positions"]
    put("model.decoder.layer_norm", dec["ln_post"])
    for side, layers in (("encoder", enc["layers"]), ("decoder", dec["layers"])):
        for i, lp in enumerate(layers):
            pre = f"model.{side}.layers.{i}"
            for ours, theirs in _HF_ATTN.items():
                put(f"{pre}.self_attn.{theirs}", lp["self_attn"][ours])
                if "cross_attn" in lp:
                    put(f"{pre}.encoder_attn.{theirs}", lp["cross_attn"][ours])
            put(f"{pre}.self_attn_layer_norm", lp["self_attn_ln"])
            if "cross_attn_ln" in lp:
                put(f"{pre}.encoder_attn_layer_norm", lp["cross_attn_ln"])
            put(f"{pre}.fc1", lp["fc1"])
            put(f"{pre}.fc2", lp["fc2"])
            put(f"{pre}.final_layer_norm", lp["final_ln"])
    return out


def prepare_params(params: Params, policy: DtypePolicy, device) -> Params:
    """Cast once for inference: LayerNorm tensors fp32, everything else the
    compute dtype, all on ``device``. A no-op copy when already prepared."""
    device = torch.device(device)
    ln_keys = {"self_attn_ln", "cross_attn_ln", "final_ln", "ln_post"}

    def walk(tree, in_ln=False):
        if isinstance(tree, dict):
            return {k: walk(v, in_ln or k in ln_keys) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, in_ln) for v in tree]
        dtype = torch.float32 if in_ln else policy.compute_dtype
        return tree.to(device=device, dtype=dtype)

    return walk(params)


def map_params(fn: Callable[[str, torch.Tensor], Any], params, prefix: str = ""):
    """The weights tree with ``fn(path, tensor)`` at every leaf; paths are
    dotted (``decoder.layers.0.fc1.weight``)."""
    if isinstance(params, dict):
        return {k: map_params(fn, v, f"{prefix}{k}.") for k, v in params.items()}
    if isinstance(params, list):
        return [map_params(fn, v, f"{prefix}{i}.") for i, v in enumerate(params)]
    return fn(prefix[:-1], params)


def named_leaves(params, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, in the tree's order."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from named_leaves(v, f"{prefix}{k}.")
    elif isinstance(params, list):
        for i, v in enumerate(params):
            yield from named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], params


# ---------------------------------------------------------------------------
# student init + language-embedding mixing
# ---------------------------------------------------------------------------

def spaced_layer_indices(n_teacher: int, n_student: int) -> List[int]:
    """Maximally-spaced teacher-layer mapping for student init:
    ``np.linspace(0, L-1, n)`` truncated to ints, the last forced to L-1."""
    idx = np.linspace(0, n_teacher - 1, n_student).astype(int).tolist()
    idx[-1] = n_teacher - 1
    return idx


def layers_to_supervise(n_student: int, n_teacher: int) -> List[int]:
    """Teacher layer supervising each student layer for the MSE
    hidden-state loss: equal increments from L//n - 1 to L-1, e.g.
    (2, 32) -> [15, 31] (another mapping than the init one)."""
    idx = np.linspace(n_teacher // n_student - 1, n_teacher - 1,
                      n_student).astype(int).tolist()
    idx[-1] = n_teacher - 1
    return idx


def _copy(tree):
    return map_params(lambda _, t: t.clone(), tree)


def init_student_from_teacher(teacher_params: Params, teacher_config: WhisperConfig,
                              decoder_layers: int,
                              decoder_layer_indices: Optional[List[int]] = None,
                              encoder_layers: Optional[int] = None) -> Params:
    """A student whose N decoder layers are copies of maximally-spaced
    teacher decoder layers (or of ``decoder_layer_indices``), plus, when
    ``encoder_layers`` is given, an encoder sliced the same way. Every
    tensor is a copy."""
    idx = decoder_layer_indices or spaced_layer_indices(
        teacher_config.decoder_layers, decoder_layers)
    if len(idx) != decoder_layers:
        raise ValueError(f"{len(idx)} layer indices for {decoder_layers} decoder layers")
    encoder = dict(teacher_params["encoder"])
    if encoder_layers is not None and encoder_layers != teacher_config.encoder_layers:
        eidx = spaced_layer_indices(teacher_config.encoder_layers, encoder_layers)
        encoder["layers"] = [encoder["layers"][i] for i in eidx]
    dec = teacher_params["decoder"]
    return _copy({
        "encoder": encoder,
        "decoder": {"embed_tokens": dec["embed_tokens"],
                    "embed_positions": dec["embed_positions"],
                    "layers": [dec["layers"][i] for i in idx],
                    "ln_post": dec["ln_post"]},
    })


def mix_language_embeddings(params: Params, target_id: int, source_ids: List[int],
                            weights: Optional[List[float]] = None) -> Params:
    """A copy of ``params`` whose ``target_id`` token embedding is the
    weighted average of the ``source_ids`` embeddings (the code-switching
    trick emb[<|zh|>] = 0.5 emb[<|zh|>] + 0.5 emb[<|en|>])."""
    emb = params["decoder"]["embed_tokens"]
    if weights is None:
        weights = [1.0 / len(source_ids)] * len(source_ids)
    mixed = sum(w * emb[i] for w, i in zip(weights, source_ids))
    emb = emb.clone()
    emb[target_id] = mixed
    new = dict(params)
    new["decoder"] = dict(params["decoder"], embed_tokens=emb)
    return new


def num_params(params: Params) -> int:
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    if isinstance(params, list):
        return sum(num_params(v) for v in params)
    return params.numel()
