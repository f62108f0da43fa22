"""Whisper model configuration (copy of taiwan_whisper_tpu/models/config.py
with torch dtypes in the policy)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Architecture hyper-parameters for a Whisper encoder-decoder.

    Field names follow HF's WhisperConfig where the concept is identical so
    that checkpoint conversion is mechanical.
    """

    vocab_size: int = 51865
    num_mel_bins: int = 80
    # Encoder
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    # Decoder
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    d_model: int = 384
    ffn_dim: int = 1536
    max_source_positions: int = 1500  # 30 s of audio after conv stride 2
    max_target_positions: int = 448
    activation: str = "gelu"
    # Special token ids (multilingual vocab layout)
    pad_token_id: int = 50257
    bos_token_id: int = 50257
    eos_token_id: int = 50257
    decoder_start_token_id: int = 50258

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.encoder_attention_heads == 0
        return self.d_model // self.encoder_attention_heads

    def with_decoder_layers(self, n: int) -> "WhisperConfig":
        """Student config: the same model with a shrunk decoder."""
        return dataclasses.replace(self, decoder_layers=n)

    def with_encoder_layers(self, n: int) -> "WhisperConfig":
        """Student config with a shrunk encoder."""
        return dataclasses.replace(self, encoder_layers=n)


# Canonical model family presets (dimensions of the published Whisper family).
_PRESETS = {
    "tiny": dict(d_model=384, ffn_dim=1536, encoder_layers=4, decoder_layers=4,
                 encoder_attention_heads=6, decoder_attention_heads=6),
    "base": dict(d_model=512, ffn_dim=2048, encoder_layers=6, decoder_layers=6,
                 encoder_attention_heads=8, decoder_attention_heads=8),
    "small": dict(d_model=768, ffn_dim=3072, encoder_layers=12, decoder_layers=12,
                  encoder_attention_heads=12, decoder_attention_heads=12),
    "medium": dict(d_model=1024, ffn_dim=4096, encoder_layers=24, decoder_layers=24,
                   encoder_attention_heads=16, decoder_attention_heads=16),
    "large-v2": dict(d_model=1280, ffn_dim=5120, encoder_layers=32, decoder_layers=32,
                     encoder_attention_heads=20, decoder_attention_heads=20),
    "large-v3": dict(d_model=1280, ffn_dim=5120, encoder_layers=32, decoder_layers=32,
                     encoder_attention_heads=20, decoder_attention_heads=20,
                     vocab_size=51866, num_mel_bins=128),
}


def get_config(name: str, **overrides) -> WhisperConfig:
    """Look up a preset by family name, e.g. ``"tiny"`` or ``"large-v2"``.

    ``name`` may also be an HF-style id like ``openai/whisper-base``.
    """
    key = name.split("/")[-1]
    key = key[len("whisper-"):] if key.startswith("whisper-") else key
    if key not in _PRESETS:
        raise ValueError(f"unknown whisper preset {name!r}; have {sorted(_PRESETS)}")
    kwargs = dict(_PRESETS[key])
    kwargs.update(overrides)
    return WhisperConfig(**kwargs)


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Compute / parameter / output dtypes. The default is bf16 compute with
    fp32 LayerNorm statistics and fp32 logits, as in the JAX package."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    @staticmethod
    def fp32() -> "DtypePolicy":
        return DtypePolicy(compute_dtype=torch.float32, output_dtype=torch.float32)

    @staticmethod
    def bf16() -> "DtypePolicy":
        return DtypePolicy()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another (``cuda:<LOCAL_RANK>`` in a multi-process run). Raises when CUDA
    is asked for (or defaulted to) but absent — entry points never fall
    back to the CPU on their own."""
    from ..parallel import mesh

    if device is None:
        device = f"cuda:{mesh.launch_env()['LOCAL_RANK']}" if mesh.initialized() else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        # fp32 policy means fp32: cuDNN would run fp32 convolutions in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
