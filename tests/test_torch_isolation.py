"""The PyTorch port stands alone: no file of taiwan_whisper_tpu_torch (nor
chip_smoke.py) imports jax or the JAX package, the package imports with
both blocked, its entry points default to CUDA and raise without it, and
its kernel wrappers never fall back on a non-CPU tensor."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import taiwan_whisper_tpu_torch
from taiwan_whisper_tpu_torch.decode.greedy import greedy_decode
from taiwan_whisper_tpu_torch.decode.rules import DecodeRules
from taiwan_whisper_tpu_torch.models.config import WhisperConfig
from taiwan_whisper_tpu_torch import cli
from taiwan_whisper_tpu_torch.ops import attention, decode_attention, layer_norm, mel_kernel
from taiwan_whisper_tpu_torch.pipeline.label import LabelConfig, label_files
from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL, WhisperTokenizer

PKG = os.path.dirname(taiwan_whisper_tpu_torch.__file__)
ROOT = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "taiwan_whisper_tpu"}


def _port_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_tops(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_imports_in_port():
    bad = {(os.path.relpath(p, ROOT), m) for p in _port_files()
           for m in _imported_tops(p) if m in FORBIDDEN}
    assert not bad


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'taiwan_whisper_tpu'): sys.modules[m] = None\n"
        "import taiwan_whisper_tpu_torch as P\n"
        "for info in pkgutil.walk_packages(P.__path__, 'taiwan_whisper_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules\n"
        "               if sys.modules[k] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise(no_cuda, tmp_path):
    cfg = WhisperConfig(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
                        encoder_layers=1, decoder_layers=1, encoder_attention_heads=4,
                        decoder_attention_heads=4, max_source_positions=60,
                        max_target_positions=48)
    rules = DecodeRules.from_special(MULTILINGUAL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        greedy_decode({}, torch.zeros(1, 60, 64), torch.zeros(1, 3, dtype=torch.int32),
                      cfg, rules)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        label_files({}, cfg, WhisperTokenizer(), [], str(tmp_path),
                    LabelConfig(vad_mode="off"))


@pytest.mark.parametrize("argv", [
    ["distill", "--manifest", "m.tsv", "--teacher", "t", "--output_dir", "o"],
    ["finetune", "--manifest", "m.tsv", "--model", "t", "--output_dir", "o"],
    ["init-student", "--teacher", "t", "--out", "o"],
], ids=["distill", "finetune", "init-student"])
def test_train_entry_points_default_to_cuda_and_raise(no_cuda, argv):
    """Stage 3's CLI entry points run on cuda unless told --device cpu, and
    raise before reading anything when CUDA is missing."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


def _decode_calls():
    from taiwan_whisper_tpu_torch.decode.beam import beam_decode
    from taiwan_whisper_tpu_torch.decode.longform import chunked_decode, sequential_decode
    from taiwan_whisper_tpu_torch.pipeline.evaluate import evaluate_manifest

    cfg = WhisperConfig(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
                        encoder_layers=1, decoder_layers=1, encoder_attention_heads=4,
                        decoder_attention_heads=4, max_source_positions=60,
                        max_target_positions=48)
    rules, tok, audio = DecodeRules.from_special(MULTILINGUAL), WhisperTokenizer(), \
        np.zeros(16000, np.float32)
    return {
        "beam_decode": lambda: beam_decode({}, torch.zeros(1, 60, 64),
                                           torch.zeros(1, 3, dtype=torch.int32), cfg, rules),
        "sequential_decode": lambda: sequential_decode({}, audio, cfg, tok),
        "chunked_decode": lambda: chunked_decode({}, audio, cfg, tok),
        "evaluate_manifest": lambda: evaluate_manifest({}, cfg, tok, "m.tsv"),
        "cli evaluate": lambda: cli.main(["evaluate", "--manifest", "m.tsv", "--model", "t"]),
        "cli transcribe": lambda: cli.main(["transcribe", "--audio", "a.wav", "--model", "t",
                                            "--output_dir", "o"]),
    }


@pytest.mark.parametrize("name", ["beam_decode", "sequential_decode", "chunked_decode",
                                  "evaluate_manifest", "cli evaluate", "cli transcribe"])
def test_decode_entry_points_default_to_cuda_and_raise(no_cuda, name):
    """Beam search, long-form decoding, evaluation and transcription run on
    cuda unless told cpu, and raise before reading anything without CUDA."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _decode_calls()[name]()


@pytest.mark.parametrize("call", [
    lambda t: mel_kernel.log10_mel_spectrum(t(2, 1600)),
    lambda t: attention.encoder_attention(t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64)),
    lambda t: decode_attention.cross_attention(t(1, 1, 2, 64), t(1, 2, 64, 8),
                                               t(1, 2, 64, 8)),
    lambda t: decode_attention.self_attention(t(1, 2, 64), t(1, 2, 64, 8), t(1, 2, 64, 8),
                                              t(1, 2, 64), t(1, 2, 64), 3),
    lambda t: attention.encoder_attention_backward(*(t(1, 8, 2, 64) for _ in range(4)),
                                                   t(1, 2, 8), t(1, 8, 2, 64)),
    lambda t: attention.encoder_attention_lse(t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64)),
    lambda t: layer_norm.layer_norm(t(4, 128), t(128), t(128)),
], ids=["mel", "encoder_attention", "cross_attention", "self_attention",
        "encoder_attention_backward", "encoder_attention_lse", "layer_norm"])
def test_kernel_wrappers_raise_off_cpu(call):
    """A wrapper takes its plain version only for CPU tensors: any other
    device launches the kernel (CUDA) or raises — never a silent fallback."""
    def meta(*shape):
        return torch.empty(shape, device="meta")

    with pytest.raises(ValueError, match="CUDA device"):
        call(meta)
