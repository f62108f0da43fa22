"""The port's log-mel (plain version, and the kernel wrapper on CPU
tensors) against the JAX frontend and the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.audio import mel as JA
from taiwan_whisper_tpu.ops.mel_kernel import log_mel_pallas
from taiwan_whisper_tpu_torch.audio import mel as A
from taiwan_whisper_tpu_torch.ops import mel_kernel


def test_log_mel_matches_jax_and_pallas():
    rng = np.random.RandomState(0)
    audio = (rng.randn(2, A.N_SAMPLES) * 0.1).astype(np.float32)
    ours = mel_kernel.log_mel(torch.from_numpy(audio)).numpy()
    assert ours.shape == (2, A.N_FRAMES, 80)
    np.testing.assert_array_equal(ours, A.log_mel(torch.from_numpy(audio)).numpy())
    np.testing.assert_allclose(ours, np.asarray(JA.log_mel(jnp.asarray(audio))), atol=1e-4)
    pallas = np.asarray(log_mel_pallas(jnp.asarray(audio), interpret=True))
    np.testing.assert_allclose(ours, pallas, atol=1e-4)


def test_frames_and_tables_match_jax():
    rng = np.random.RandomState(1)
    audio = rng.randn(2, 19200).astype(np.float32)  # one 1.2 s tiny-model chunk
    np.testing.assert_array_equal(A.frame_audio(torch.from_numpy(audio)).numpy(),
                                  np.asarray(JA.frame_audio(jnp.asarray(audio))))
    for mine, ref in zip(A.dft_matrices(), JA.dft_matrices()):
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(A.mel_filter_bank(80), JA.mel_filter_bank(80))
    np.testing.assert_allclose(A.log_mel(torch.from_numpy(audio)).numpy(),
                               np.asarray(JA.log_mel(jnp.asarray(audio))), atol=1e-4)


# ---------------------------------------------------------------------------
# what csrc/mel.cu is given, and its arithmetic in numpy
# ---------------------------------------------------------------------------

def _kernel_model(audio, num_mel_bins, table, cdtype):
    """csrc/mel.cu's arithmetic in numpy, in the kernel's order, in complex
    ``cdtype``: the reflect index, the window, pass 1 (radix 8 over n1 and
    the W_200 twiddles), pass 2 (5 x 5 with the W_25 twiddles), the split
    into 201 bins and their power (of 2 X), the sparse mel product, the
    factor 1/4 and log10 through log2. Every constant comes from ``table``.
    Returns (the power |X|^2 [B, F, 201], log10 mel)."""
    rdtype = np.float32 if cdtype == np.complex64 else np.float64
    tab = table.astype(rdtype)
    win = tab[:A.N_FFT]
    tw = (tab[A.N_FFT::2] + 1j * tab[A.N_FFT + 1::2]).astype(cdtype)  # W_400^j
    n = audio.shape[1]
    f = n // A.HOP_LENGTH
    pos = np.arange(f)[:, None] * A.HOP_LENGTH + np.arange(A.N_FFT)[None]
    x = audio.astype(rdtype)[:, mel_kernel.reflect_index(pos, n)] * win   # [B, F, 400]
    z = (x[..., 0::2] + 1j * x[..., 1::2]).astype(cdtype)                # z[m], m = 25 n1 + n2
    neg_i = lambda a: (a.imag - 1j * a.real).astype(cdtype)              # -i a

    def dft4(p0, p1, p2, p3):
        s0, s1, s2, s3 = p0 + p2, p0 - p2, p1 + p3, neg_i(p1 - p3)
        return [s0 + s2, s1 + s3, s0 - s2, s1 - s3]

    r = tab[A.N_FFT + 2 * 50]                                            # cos(pi / 4)
    a = [z[..., 25 * n1:25 * n1 + 25] for n1 in range(8)]                # [B, F, 25] each
    e, o = dft4(a[0], a[2], a[4], a[6]), dft4(a[1], a[3], a[5], a[7])
    o = [o[0], (r * (o[1].real + o[1].imag) + 1j * (r * (o[1].imag - o[1].real))).astype(cdtype),
         neg_i(o[2]),
         (r * (o[3].imag - o[3].real) + 1j * (-r * (o[3].real + o[3].imag))).astype(cdtype)]
    y = [e[k % 4] + o[k % 4] if k < 4 else e[k % 4] - o[k % 4] for k in range(8)]
    n2 = np.arange(25)
    y = np.stack([y[0]] + [y[k1] * tw[2 * n2 * k1] for k1 in range(1, 8)], axis=2)  # [B,F,k1,n2]

    c1, s1 = tab[A.N_FFT + 160], -tab[A.N_FFT + 161]
    c2, s2 = tab[A.N_FFT + 320], -tab[A.N_FFT + 321]

    def dft5(x0, x1, x2, x3, x4):
        a1, b1, a2, b2 = x1 + x4, x1 - x4, x2 + x3, x2 - x3
        t1, t2 = x0 + c1 * a1 + c2 * a2, x0 + c2 * a1 + c1 * a2
        u1, u2 = neg_i(s1 * b1 + s2 * b2), neg_i(s2 * b1 - s1 * b2)
        return [x0 + a1 + a2, t1 + u1, t2 + u2, t2 - u2, t1 - u1]

    v = [y[..., i] for i in range(25)]                                   # v[5 a + b]
    for b in range(5):
        for c, out in enumerate(dft5(*(v[5 * a_ + b] for a_ in range(5)))):
            v[5 * c + b] = out
    for c in range(1, 5):
        for b in range(1, 5):
            v[5 * c + b] = v[5 * c + b] * tw[16 * b * c]
    for c in range(5):
        v[5 * c:5 * c + 5] = dft5(*v[5 * c:5 * c + 5])
    zk = np.empty(z.shape, cdtype)                                       # Z[k1 + 8 (c + 5 d)]
    for k1 in range(8):
        for c in range(5):
            for d in range(5):
                zk[..., k1 + 8 * (c + 5 * d)] = v[5 * c + d][..., k1]

    # the split, every k < 200 from Z[k] and conj Z[200 - k]: |2 X[k]|^2 =
    # |A + W' D|^2 with A, D their sum and difference and W' = -i W_400^k;
    # |2 X[200]|^2 = |A_0 - W'_0 D_0|^2
    k = np.arange(200)
    za, zr = zk[..., k], np.conj(zk[..., (200 - k) % 200])
    p = neg_i(tw[k]) * (za - zr)
    power = np.empty(zk.shape[:-1] + (A.N_FREQS,), rdtype)
    norm2 = lambda a: a.real * a.real + a.imag * a.imag
    power[..., :200] = norm2(za + zr + p)
    power[..., 200] = norm2(za[..., 0] + zr[..., 0] - p[..., 0])
    spans, weights = mel_kernel.mel_slices(num_mel_bins)
    mel = np.zeros(power.shape[:-1] + (num_mel_bins,), rdtype)
    for m in range(num_mel_bins):
        start, off = spans[m]
        for j in range(spans[m + 1, 1] - off):
            mel[..., m] += weights[off + j].astype(rdtype) * power[..., start + j]
    log10 = np.log2(np.maximum(rdtype(0.25) * mel, rdtype(1e-10))) * rdtype(np.log10(2.0))
    return power / 4, log10


def _tail(log_spec):
    log_spec = np.maximum(log_spec, log_spec.max(axis=(1, 2), keepdims=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def test_fft_tables_are_float64_values_rounded():
    """The kernel's table: the periodic Hann window of dft_matrices(), then
    W_400^j, each computed in float64 and rounded to fp32 once."""
    t32, t64 = mel_kernel.fft_tables(), mel_kernel.fft_tables(np.float64)
    assert t32.dtype == np.float32 and t32.shape == (3 * A.N_FFT,)
    np.testing.assert_array_equal(t32, t64.astype(np.float32))
    j = np.arange(A.N_FFT)
    np.testing.assert_allclose(t64[A.N_FFT::2] + 1j * t64[A.N_FFT + 1::2],
                               np.exp(-2j * np.pi * j / A.N_FFT), rtol=0, atol=1e-15)
    w_cos = A.dft_matrices()[0]
    np.testing.assert_array_equal(t32[:A.N_FFT], w_cos[:, 0])  # the window is W_cos's column 0


def test_kernel_fft_order_is_the_dft():
    """The kernel's radix order (8 x 5 x 5 on the packed frame, then the
    split) is the DFT of the windowed frame: in float64 with float64 tables
    it matches the float64 window-folded DFT to 1e-9 of the largest power.
    With the fp32 tables the kernel receives it matches the products with
    dft_matrices() to 1e-6 relative (the tables' own fp32 rounding, ~6e-8
    per entry, through three stages)."""
    rng = np.random.RandomState(2)
    audio = (rng.randn(2, 6400) * 0.1).astype(np.float64)
    n = audio.shape[1]
    pos = np.arange(n // A.HOP_LENGTH)[:, None] * A.HOP_LENGTH + np.arange(A.N_FFT)[None]
    frames = audio[:, mel_kernel.reflect_index(pos, n)]
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(A.N_FFT) / A.N_FFT))
    spec = np.fft.rfft(frames * window, axis=-1)
    exact = spec.real ** 2 + spec.imag ** 2
    power, _ = _kernel_model(audio, 80, mel_kernel.fft_tables(np.float64), np.complex128)
    assert np.abs(power - exact).max() <= 1e-9 * exact.max()
    w_cos, w_sin = (w.astype(np.float64) for w in A.dft_matrices())
    products = (frames @ w_cos) ** 2 + (frames @ w_sin) ** 2
    power32, _ = _kernel_model(audio, 80, mel_kernel.fft_tables(), np.complex128)
    assert np.abs(power32 - products).max() <= 1e-6 * products.max()


@pytest.mark.parametrize("num_mel_bins", [80, 128])
def test_kernel_model_in_fp32_matches_jax_and_pallas(num_mel_bins):
    """The kernel's arithmetic in fp32 with the fp32 tables and filter
    slices it receives, through the (x+4)/4 tail, against the JAX log_mel
    and log_mel_pallas in interpret mode: 1e-4, the tolerance chip_smoke.py
    holds the kernel to against the plain version."""
    rng = np.random.RandomState(3)
    audio = (rng.randn(2, 64000) * 0.1).astype(np.float32)  # 400 frames: 2 Pallas blocks
    _, log_spec = _kernel_model(audio, num_mel_bins, mel_kernel.fft_tables(), np.complex64)
    ours = _tail(log_spec)
    assert ours.shape == (2, 400, num_mel_bins)
    ref = np.asarray(JA.log_mel(jnp.asarray(audio), num_mel_bins))
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    pallas = np.asarray(log_mel_pallas(jnp.asarray(audio), num_mel_bins, interpret=True))
    np.testing.assert_allclose(ours, pallas, atol=1e-4)
    plain = A.log_mel(torch.from_numpy(audio), num_mel_bins).numpy()
    np.testing.assert_allclose(ours, plain, atol=1e-4)


@pytest.mark.parametrize("n", [320, 19200, 64000])
def test_reflect_index_is_reflect_pad(n):
    """The kernel loads padded[j] from audio[reflect_index(j, n)]: over every
    padded position, from the shortest audio the wrapper takes (320) up."""
    audio = torch.from_numpy(np.random.RandomState(4).randn(2, n).astype(np.float32))
    padded = A.reflect_pad(audio).numpy()
    idx = mel_kernel.reflect_index(np.arange(n + A.N_FFT), n)
    np.testing.assert_array_equal(audio.numpy()[:, idx], padded)


@pytest.mark.parametrize("num_mel_bins", [80, 128])
def test_mel_slices_rebuild_the_filter_bank(num_mel_bins):
    """The (start, offset) rows and weights the kernel receives rebuild
    mel_filter_bank exactly, hold every nonzero and fit the kernel's room."""
    fb = A.mel_filter_bank(num_mel_bins)
    spans, weights = mel_kernel.mel_slices(num_mel_bins)
    assert spans.dtype == np.int32 and weights.dtype == np.float32
    assert spans.shape == (num_mel_bins + 1, 2) and spans[-1, 1] == len(weights)
    rebuilt = np.zeros_like(fb)
    for m in range(num_mel_bins):
        start, off = spans[m]
        count = spans[m + 1, 1] - off
        rebuilt[start:start + count, m] = weights[off:off + count]
    np.testing.assert_array_equal(rebuilt, fb)
    assert len(weights) == np.count_nonzero(fb) <= mel_kernel.MAX_WEIGHTS
    assert num_mel_bins <= mel_kernel.MAX_MELS
