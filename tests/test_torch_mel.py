"""The port's log-mel (plain version, and the kernel wrapper on CPU
tensors) against the JAX frontend and the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
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
