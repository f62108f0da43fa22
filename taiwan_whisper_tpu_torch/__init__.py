"""taiwan_whisper_tpu_torch — the PyTorch + CUDA port of taiwan_whisper_tpu.

A second package beside the JAX reference. Plain tensor code is PyTorch;
each Pallas kernel of the JAX package on the ported path is a CUDA C++
kernel for Hopper (``csrc/``, built by ``ops/_build.py`` at first use).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.

This package never imports ``jax`` or ``taiwan_whisper_tpu``.
"""

__version__ = "0.1.0"

from .models.config import DtypePolicy, WhisperConfig, get_config  # noqa: F401
