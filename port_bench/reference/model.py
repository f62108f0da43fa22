"""Plain Whisper in PyTorch: the log-mel frontend, the encoder and the
teacher-forced decoder, in float32 with TF32 off.

It reads weights by their Hugging Face names from a dict of tensors
(whatever their stored type: each is upcast where it is used) and follows
the published architecture: a two-convolution stem with GELU, sinusoidal
encoder positions, pre-LayerNorm blocks (eps 1e-5) with 1/sqrt(d_head)
attention, an exact-erf GELU MLP, a final LayerNorm, and logits against the
tied token embedding. Attention runs in blocks of rows so that a batch of
32 fits beside everything else.

``Precision`` is where the control comes in: ``fp8`` rounds both operands
of every matrix product (the convolutions, projections, attention products
and the logits) to float8 e4m3 with one scale per tensor, the step below
the bfloat16 products the configurations state. The backward sees the
rounded operands that the products saved, and passes gradients straight
through the rounding.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
ATTN_ROWS = 4  # batch rows per attention block


def strict_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """Rounding applied to the operands of every product: ``fp32`` (none)
    or ``fp8`` (e4m3, per-tensor scale to its largest magnitude)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind == "fp32":
            return x
        scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
        q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (q - x.detach())  # the rounded value; gradients pass straight


# ---------------------------------------------------------------------------
# log-mel (Whisper's: periodic Hann 400, hop 160, Slaney mel, log10)
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) * (27.0 / np.log(6.4))
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = 200.0 * m / 3.0
    log = 1000.0 * np.exp(np.log(6.4) / 27.0 * (np.maximum(m, 15.0) - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-normalised triangles, [N_FFT // 2 + 1, n_mels] (librosa's)."""
    n_freqs = N_FFT // 2 + 1
    fft_f = np.linspace(0.0, SAMPLE_RATE / 2, n_freqs)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0), n_mels + 2))
    diff = np.diff(pts)
    slopes = pts[None, :] - fft_f[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb * (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[None, :]


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, N] -> [B, N // HOP, n_mels] float32: |STFT|^2 of the reflect-
    padded signal (last frame dropped), mel, log10 clamped at 1e-10, each
    row floored at its max - 8, then (x + 4) / 4. Computed in float64."""
    x = audio.double()
    win = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=win, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.abs() ** 2  # [B, F, T]
    fb = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    mel = torch.einsum("bft,fm->btm", power, fb)
    lm = torch.log10(torch.clamp(mel, min=1e-10))
    lm = torch.maximum(lm, lm.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((lm + 4.0) / 4.0).float()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Whisper:
    """Weights by HF name (``encoder.layers.0.fc1.weight``, ...); ``cfg`` is
    a configuration file's dict."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: dict,
                 precision: Precision = Precision()):
        self.w = weights
        self.cfg = cfg
        self.q = precision

    def _t(self, name: str) -> torch.Tensor:
        return self.w[name].float()

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = self.q(x) @ self.q(self._t(f"{name}.weight")).t()
        b = self.w.get(f"{name}.bias")
        return y if b is None else y + b.float()

    def ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self._t(f"{name}.weight"),
                            self._t(f"{name}.bias"), 1e-5)

    def _heads(self, x: torch.Tensor, n: int) -> torch.Tensor:
        b, s, d = x.shape
        return x.view(b, s, n, d // n).transpose(1, 2)  # [B, H, S, Dh]

    def attention(self, q, k, v, n_heads: int, causal: bool = False) -> torch.Tensor:
        q, k, v = (self._heads(t, n_heads) for t in (q, k, v))
        scale = q.shape[-1] ** -0.5
        outs = []
        for r in range(0, q.shape[0], ATTN_ROWS):
            s = (self.q(q[r:r + ATTN_ROWS]) * scale) @ self.q(k[r:r + ATTN_ROWS]).transpose(-1, -2)
            if causal:
                n = s.shape[-1]
                mask = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
                s = s.masked_fill(~mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            outs.append(self.q(p) @ self.q(v[r:r + ATTN_ROWS]))
        o = torch.cat(outs)  # [B, H, S, Dh]
        b, h, s, dh = o.shape
        return o.transpose(1, 2).reshape(b, s, h * dh)

    def _conv(self, x: torch.Tensor, name: str, stride: int) -> torch.Tensor:
        return F.conv1d(self.q(x), self.q(self._t(f"{name}.weight")), self._t(f"{name}.bias"),
                        stride=stride, padding=1)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, 3000, n_mels] -> [B, 1500, d]."""
        c = self.cfg
        x = F.gelu(self._conv(mel.transpose(1, 2), "encoder.conv1", 1))
        x = F.gelu(self._conv(x, "encoder.conv2", 2)).transpose(1, 2)
        x = x + self._t("encoder.embed_positions.weight")[: x.shape[1]]
        for i in range(c["encoder_layers"]):
            p = f"encoder.layers.{i}"
            h = self.ln(x, f"{p}.self_attn_layer_norm")
            a = self.attention(self.linear(h, f"{p}.self_attn.q_proj"),
                               self.linear(h, f"{p}.self_attn.k_proj"),
                               self.linear(h, f"{p}.self_attn.v_proj"),
                               c["encoder_attention_heads"])
            x = x + self.linear(a, f"{p}.self_attn.out_proj")
            h = self.ln(x, f"{p}.final_layer_norm")
            x = x + self.linear(F.gelu(self.linear(h, f"{p}.fc1")), f"{p}.fc2")
        return self.ln(x, "encoder.layer_norm")

    def decode(self, enc: torch.Tensor, tokens: torch.Tensor,
               layers: Optional[list] = None) -> torch.Tensor:
        """Teacher-forced logits [B, U, vocab] of ``tokens`` [B, U] over
        ``enc``; ``layers`` names the decoder layers to run (all)."""
        c = self.cfg
        n = c["decoder_attention_heads"]
        u = tokens.shape[1]
        emb = self._t("decoder.embed_tokens.weight")
        x = emb[tokens.long()] + self._t("decoder.embed_positions.weight")[:u]
        for i in (range(c["decoder_layers"]) if layers is None else layers):
            p = f"decoder.layers.{i}"
            h = self.ln(x, f"{p}.self_attn_layer_norm")
            a = self.attention(self.linear(h, f"{p}.self_attn.q_proj"),
                               self.linear(h, f"{p}.self_attn.k_proj"),
                               self.linear(h, f"{p}.self_attn.v_proj"), n, causal=True)
            x = x + self.linear(a, f"{p}.self_attn.out_proj")
            h = self.ln(x, f"{p}.encoder_attn_layer_norm")
            a = self.attention(self.linear(h, f"{p}.encoder_attn.q_proj"),
                               self.linear(enc, f"{p}.encoder_attn.k_proj"),
                               self.linear(enc, f"{p}.encoder_attn.v_proj"), n)
            x = x + self.linear(a, f"{p}.encoder_attn.out_proj")
            h = self.ln(x, f"{p}.final_layer_norm")
            x = x + self.linear(F.gelu(self.linear(h, f"{p}.fc1")), f"{p}.fc2")
        x = self.ln(x, "decoder.layer_norm")
        return self.q(x) @ self.q(emb).t()


def encode_blocks(model: Whisper, mel: torch.Tensor, rows: int = 4) -> torch.Tensor:
    with torch.no_grad():
        return torch.cat([model.encode(mel[r:r + rows]) for r in range(0, mel.shape[0], rows)])

