"""The port's plain encoder attention (what the kernel wrapper runs on CPU
tensors) against the Pallas encoder kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.ops.attention import encoder_attention as pallas_encoder_attention
from taiwan_whisper_tpu_torch.ops.attention import attention_plain, encoder_attention


@pytest.mark.parametrize("s", [160, 300])  # 300 leaves a ragged last block
def test_encoder_attention_matches_pallas(s):
    rng = np.random.RandomState(s)
    q, k, v = (rng.randn(2, s, 4, 64).astype(np.float32) for _ in range(3))
    ref = np.asarray(pallas_encoder_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), interpret=True))
    ours = encoder_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert ours.shape == (2, s, 4, 64) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def test_plain_attention_mask_keeps_true():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 5, 2, 64).astype(np.float32)) for _ in range(3))
    causal = torch.tril(torch.ones(5, 5, dtype=torch.bool))[None, None]
    out = attention_plain(q, k, v, causal)
    # the first query sees only the first key: its output is v[0]
    np.testing.assert_allclose(out[0, 0].numpy(), v[0, 0].numpy(), atol=1e-6)
