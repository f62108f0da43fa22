"""Checkpoint I/O: HF-format model dirs (config.json + model.safetensors).

The machine with the card has no ``safetensors`` package, so the format is
read and written here with numpy: an 8-byte little-endian header length, a
JSON header of ``{name: {dtype, shape, data_offsets}}``, then the raw
buffers. bf16 is carried as 16-bit words and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from .config import WhisperConfig
from .params import Params, load_hf_state_dict, to_hf_state_dict

_NP = {"F32": np.float32, "F16": np.float16, "F64": np.float64,
       "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
       "U8": np.uint8, "BOOL": np.bool_, "BF16": np.int16}
_ST = {torch.float32: "F32", torch.float16: "F16", torch.float64: "F64",
       torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
       torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL",
       torch.bfloat16: "BF16"}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of a .safetensors file as CPU tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = np.fromfile(f, dtype=np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = info["dtype"]
        if dt not in _NP:
            raise ValueError(f"{path}: unsupported safetensors dtype {dt} ({name})")
        a, b = info["data_offsets"]
        arr = buf[a:b].view(_NP[dt]).reshape(info["shape"])
        t = torch.from_numpy(arr.copy())
        out[name] = t.view(torch.bfloat16) if dt == "BF16" else t
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Dict[str, str] = None):
    header, chunks, off = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _ST[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        chunks.append(raw)
        off += len(raw)
    if metadata:
        header["__metadata__"] = metadata
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in chunks:
            f.write(raw)


def config_from_hf_dict(d: dict) -> WhisperConfig:
    return WhisperConfig(
        vocab_size=d["vocab_size"],
        num_mel_bins=d["num_mel_bins"],
        encoder_layers=d["encoder_layers"],
        encoder_attention_heads=d["encoder_attention_heads"],
        decoder_layers=d["decoder_layers"],
        decoder_attention_heads=d["decoder_attention_heads"],
        d_model=d["d_model"],
        ffn_dim=d.get("encoder_ffn_dim", d.get("decoder_ffn_dim")),
        max_source_positions=d.get("max_source_positions", 1500),
        max_target_positions=d.get("max_target_positions", 448),
        decoder_start_token_id=d.get("decoder_start_token_id", 50258),
        eos_token_id=d.get("eos_token_id", 50257),
        pad_token_id=d.get("pad_token_id", 50257),
        bos_token_id=d.get("bos_token_id", 50257),
    )


def config_to_hf_dict(c: WhisperConfig) -> dict:
    return {
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper",
        "vocab_size": c.vocab_size,
        "num_mel_bins": c.num_mel_bins,
        "encoder_layers": c.encoder_layers,
        "encoder_attention_heads": c.encoder_attention_heads,
        "decoder_layers": c.decoder_layers,
        "decoder_attention_heads": c.decoder_attention_heads,
        "d_model": c.d_model,
        "encoder_ffn_dim": c.ffn_dim,
        "decoder_ffn_dim": c.ffn_dim,
        "max_source_positions": c.max_source_positions,
        "max_target_positions": c.max_target_positions,
        "decoder_start_token_id": c.decoder_start_token_id,
        "eos_token_id": c.eos_token_id,
        "pad_token_id": c.pad_token_id,
        "bos_token_id": c.bos_token_id,
    }


def save_hf_checkpoint(model_dir: str, params: Params, config: WhisperConfig):
    """Write an HF-format dir (config.json + model.safetensors); tensors keep
    their dtype."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(config_to_hf_dict(config), f, indent=2)
    write_safetensors(os.path.join(model_dir, "model.safetensors"),
                      to_hf_state_dict(params), metadata={"format": "pt"})


def load_model(model_dir: str) -> Tuple[Params, WhisperConfig]:
    """Load an HF model dir -> (weights on the CPU in their stored dtype,
    config). ``prepare_params`` moves and casts them."""
    st_path = os.path.join(model_dir, "model.safetensors")
    if not os.path.exists(st_path):
        raise FileNotFoundError(f"no model.safetensors in {model_dir}")
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        config = config_from_hf_dict(json.load(f))
    return load_hf_state_dict(read_safetensors(st_path), config), config
