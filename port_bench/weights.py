"""Seeded Whisper weights in the published Hugging Face layout, made on the
device in the type they are served in.

Every weight matrix and embedding is a std-0.02 normal (the init of
``WhisperForConditionalGeneration``), and the encoder positions are
Whisper's fixed sinusoids. LayerNorm shifts are normals of std
``AFFINE_STD`` and LayerNorm scales 1 plus such a normal; the biases of
the projections and convolutions are normals of ``AFFINE_STD`` times the
typical size of what they are added to at this width against large-v2's
(``sqrt(d_model / 1280)``), so that at any width they shift a product by
about a seventh of its spread and do not drown it. That is large enough
that a bias left out, applied twice, or a scale and shift swapped moves
the logits and the losses that ``correct`` compares, as a trained model's
would (HF's init makes them 0 and 1, which hides all three). Everything
comes from one
``torch.randn`` call on a generator seeded from the run's seed, and each
tensor is a view of that one buffer, so making 1.55 B parameters takes a
few large calls. The same tensors go to the port (through
``models/params.py::load_hf_state_dict``) and to the reference; nothing is
written to disk.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

WEIGHT_STD = 0.02
AFFINE_STD = 0.1  # LayerNorm shifts, and biases at d_model 1280; scales are 1 + this normal


def hf_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every tensor: init is weight, bias, shift,
    scale or sinusoids."""
    d, f = cfg["d_model"], cfg["encoder_ffn_dim"]
    out: List[Tuple[str, tuple, str]] = []

    def dense(name, d_in, d_out, bias=True):
        out.append((f"{name}.weight", (d_out, d_in), "weight"))
        if bias:
            out.append((f"{name}.bias", (d_out,), "bias"))

    def ln(name):
        out.append((f"{name}.weight", (d,), "scale"))
        out.append((f"{name}.bias", (d,), "shift"))

    def attn(name):
        dense(f"{name}.q_proj", d, d)
        dense(f"{name}.k_proj", d, d, bias=False)
        dense(f"{name}.v_proj", d, d)
        dense(f"{name}.out_proj", d, d)

    out.append(("encoder.conv1.weight", (d, cfg["num_mel_bins"], 3), "weight"))
    out.append(("encoder.conv1.bias", (d,), "bias"))
    out.append(("encoder.conv2.weight", (d, d, 3), "weight"))
    out.append(("encoder.conv2.bias", (d,), "bias"))
    out.append(("encoder.embed_positions.weight", (cfg["max_source_positions"], d),
                "sinusoids"))
    for i in range(cfg["encoder_layers"]):
        p = f"encoder.layers.{i}"
        attn(f"{p}.self_attn")
        ln(f"{p}.self_attn_layer_norm")
        dense(f"{p}.fc1", d, f)
        dense(f"{p}.fc2", f, d)
        ln(f"{p}.final_layer_norm")
    ln("encoder.layer_norm")
    out.append(("decoder.embed_tokens.weight", (cfg["vocab_size"], d), "weight"))
    out.append(("decoder.embed_positions.weight", (cfg["max_target_positions"], d), "weight"))
    fd = cfg["decoder_ffn_dim"]
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.layers.{i}"
        attn(f"{p}.self_attn")
        ln(f"{p}.self_attn_layer_norm")
        attn(f"{p}.encoder_attn")
        ln(f"{p}.encoder_attn_layer_norm")
        dense(f"{p}.fc1", d, fd)
        dense(f"{p}.fc2", fd, d)
        ln(f"{p}.final_layer_norm")
    ln("decoder.layer_norm")
    return out


def sinusoids(length: int, channels: int) -> np.ndarray:
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def make_state_dict(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The HF state dict (no ``model.`` prefix) on ``device``."""
    spec = hf_shapes(cfg)
    kinds = ("weight", "bias", "shift", "scale")
    sizes = {k: sum(int(np.prod(shape)) for _, shape, init in spec if init == k) for k in kinds}
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device, dtype=dtype)
    pools, at = {}, 0
    for k in kinds:  # one region of the buffer a kind, scaled in one call each
        pools[k] = flat[at: at + sizes[k]]
        at += sizes[k]
        pools[k].mul_({"weight": WEIGHT_STD, "shift": AFFINE_STD, "scale": AFFINE_STD,
                       "bias": AFFINE_STD * math.sqrt(cfg["d_model"] / 1280)}[k])
    pools["scale"].add_(1.0)
    pos = dict.fromkeys(kinds, 0)
    sd = {}
    for name, shape, init in spec:
        if init == "sinusoids":
            sd[name] = torch.from_numpy(sinusoids(*shape)).to(device=device, dtype=dtype)
            continue
        n = int(np.prod(shape))
        sd[name] = pools[init][pos[init]: pos[init] + n].view(shape)
        pos[init] += n
    return sd


def hf_config(cfg: dict) -> dict:
    """The ``config.json`` keys of a configuration file."""
    keys = ("vocab_size", "num_mel_bins", "encoder_layers", "encoder_attention_heads",
            "decoder_layers", "decoder_attention_heads", "d_model", "encoder_ffn_dim",
            "decoder_ffn_dim", "max_source_positions", "max_target_positions",
            "decoder_start_token_id", "eos_token_id", "pad_token_id", "bos_token_id")
    return {k: cfg[k] for k in keys}
