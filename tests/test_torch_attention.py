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


@pytest.mark.parametrize("dtype", [np.float32])
def test_plain_attention_grads_match_jax(dtype):
    """dq/dk/dv of the port's plain attention (the CPU path of the encoder
    attention's autograd function) equal jax.grad of the JAX model's
    ``_attention``."""
    import jax

    from taiwan_whisper_tpu.models.whisper import _attention
    from taiwan_whisper_tpu_torch.ops.attention import (attention_backward_plain,
                                                        encoder_attention_backward)

    rng = np.random.RandomState(3)
    q, k, v, dout = (rng.randn(2, 70, 4, 64).astype(dtype) for _ in range(4))

    def f(q, k, v):
        return jnp.sum(_attention(q, k, v, None, jnp.float32) * dout)

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    got = attention_backward_plain(tq, tk, tv, tdo)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, err_msg=name)
    # the wrapper on CPU tensors is the plain version; autograd through
    # encoder_attention gives the same gradients
    wrapped = encoder_attention_backward(tq, tk, tv, None, None, tdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(encoder_attention(*leaves), leaves, tdo)
    for a, b, c in zip(got, wrapped, auto):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_lse_plain_is_logsumexp_of_scaled_scores():
    from taiwan_whisper_tpu_torch.ops.attention import encoder_attention_lse

    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(1, 9, 2, 64).astype(np.float32)) for _ in range(3))
    out, lse = encoder_attention_lse(q, k, v)
    s = np.einsum("bqhd,bkhd->bhqk", q.numpy() / 8.0, k.numpy()).astype(np.float64)
    want = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5)
    assert torch.equal(out, attention_plain(q, k, v))


@pytest.mark.parametrize("layout", ["contiguous", "qkv_views"])
def test_tma_map_params(layout):
    """The tensor map the bf16 kernels build: dims (d, h, s, b), the byte
    strides of h, s and b read from the tensor, a box of one head's rows,
    128-byte swizzle."""
    from taiwan_whisper_tpu_torch.ops.attention import tma_map_params

    b, s, h = 2, 300, 4
    if layout == "contiguous":
        t = torch.zeros((b, s, h, 64), dtype=torch.bfloat16)
        want = (128, h * 128, s * h * 128)
    else:  # q, k or v as a view of one [B, S, 3, H, 64] buffer
        t = torch.zeros((b, s, 3, h, 64), dtype=torch.bfloat16)[:, :, 1]
        want = (128, 3 * h * 128, s * 3 * h * 128)
    got = tma_map_params(t, 64)
    assert got == {"dims": (64, h, s, b), "strides_bytes": want, "box": (64, 1, 64, 1),
                   "swizzle_bytes": 128}
    assert tma_map_params(t, 128)["box"] == (64, 1, 128, 1)


@pytest.mark.parametrize("bad", ["head_stride", "base", "fp32", "box"])
def test_tma_map_params_rejects(bad):
    """TMA needs every stride and the base on 16 bytes and a 128-byte row."""
    from taiwan_whisper_tpu_torch.ops.attention import tma_map_params

    if bad == "head_stride":  # heads 68 elements (136 bytes) apart
        t = torch.zeros((1, 8, 2, 68), dtype=torch.bfloat16)[..., :64]
    elif bad == "base":  # the whole tensor 2 bytes off
        t = torch.zeros(1 + 8 * 2 * 64, dtype=torch.bfloat16)[1:].view(1, 8, 2, 64)
    elif bad == "fp32":
        t = torch.zeros((1, 8, 2, 64), dtype=torch.float32)
    else:
        t = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tma_map_params(t, 512 if bad == "box" else 64)


def test_tma_map_words_are_what_the_kernels_receive():
    """The bf16 C entries take twelve int64 words per tensor
    (hopper::MapParams): tma_map_params' dims, byte strides, box of
    TMA_BOX_ROWS rows and swizzle, tensor by tensor in argument order; the
    fp32 entries take none."""
    from taiwan_whisper_tpu_torch.ops.attention import TMA_BOX_ROWS, tma_map_words

    b, s, h = 2, 300, 4
    q = torch.zeros((b, s, h, 64), dtype=torch.bfloat16)
    k = torch.zeros((b, s, 3, h, 64), dtype=torch.bfloat16)[:, :, 1]
    assert list(tma_map_words(q, k)) == [
        64, h, s, b, 128, h * 128, s * h * 128, 64, 1, TMA_BOX_ROWS, 1, 128,
        64, h, s, b, 128, 3 * h * 128, s * 3 * h * 128, 64, 1, TMA_BOX_ROWS, 1, 128]
    assert tma_map_words(q.float(), k.float()) is None


# (Sq, Sk): one query tile's worth, and ragged lengths either way round
@pytest.mark.parametrize("causal,sq,sk", [(True, 7, 7), (True, 33, 33), (False, 7, 19),
                                          (False, 19, 7)])
def test_decoder_attention_matches_jax(causal, sq, sk):
    """``decoder_attention`` on CPU tensors (the plain version, with the
    tril mask when causal) equals the JAX model's ``_attention`` with the
    same mask, at fp32."""
    from taiwan_whisper_tpu.models.whisper import _attention
    from taiwan_whisper_tpu_torch.ops.attention import decoder_attention

    rng = np.random.RandomState(sq * 100 + sk)
    q = rng.randn(2, sq, 3, 64).astype(np.float32)
    k, v = (rng.randn(2, sk, 3, 64).astype(np.float32) for _ in range(2))
    mask = jnp.tril(jnp.ones((sq, sq), bool))[None, None] if causal else None
    ref = np.asarray(_attention(*(jnp.asarray(x) for x in (q, k, v)), mask, jnp.float32))
    ours = decoder_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert ours.shape == (2, sq, 3, 64) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
    if causal:  # the first query sees only the first key
        np.testing.assert_allclose(ours[:, 0].numpy(), v[:, 0], atol=1e-6)


@pytest.mark.parametrize("bad", ["head_dim", "causal_lengths", "batch", "heads", "kv_shapes"])
def test_decoder_attention_rejects(bad):
    """The wrapper's checks hold on any device: a 64-wide head, k and v of
    one shape sharing q's batch and heads, and Sq == Sk when causal."""
    from taiwan_whisper_tpu_torch.ops.attention import decoder_attention

    q, k, v = torch.zeros(2, 5, 3, 64), torch.zeros(2, 9, 3, 64), torch.zeros(2, 9, 3, 64)
    causal = False
    if bad == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif bad == "causal_lengths":
        causal = True
    elif bad == "batch":
        k, v = k[:1], v[:1]
    elif bad == "heads":
        k, v = k[:, :, :2], v[:, :, :2]
    else:
        v = v[:, :8]
    with pytest.raises(ValueError):
        decoder_attention(q, k, v, causal=causal)


@pytest.mark.parametrize("case", ["applies", "grad", "attention_mask", "fp32", "cpu"])
def test_decoder_kernel_route(case):
    """``_decoder_train_layer`` takes the kernel only for a CUDA bf16 q with
    no gradient recorded and the plain tril mask: under grad, with an
    ``attention_mask``, at fp32 and on the CPU the plain path runs. The
    predicate reads q's device and dtype alone, so a stand-in with a CUDA
    device tests it here."""
    from types import SimpleNamespace

    from taiwan_whisper_tpu_torch.models.whisper import _decoder_kernel_applies

    q = SimpleNamespace(device=torch.device("cpu" if case == "cpu" else "cuda"),
                        dtype=torch.float32 if case == "fp32" else torch.bfloat16)
    with torch.set_grad_enabled(case == "grad"):
        got = _decoder_kernel_applies(q, plain_tril=case != "attention_mask")
    assert got == (case == "applies")


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_decode_train_route_matches_jax(route, monkeypatch):
    """decode_train on CPU with the route forced on (each layer calls
    ``decoder_attention``, causal then cross, whose CPU path is the plain
    version) and as it runs on CPU (never calls it) both equal the JAX
    model's teacher-forcing logits at fp32."""
    from taiwan_whisper_tpu.models import whisper as JM
    from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
    from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
    from taiwan_whisper_tpu.models.params import init_params as jax_init_params
    from taiwan_whisper_tpu_torch.models import whisper as M
    from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
    from taiwan_whisper_tpu_torch.models.params import from_jax_params, prepare_params

    small = dict(vocab_size=300, d_model=128, ffn_dim=128, encoder_layers=1, decoder_layers=2,
                 encoder_attention_heads=2, decoder_attention_heads=2,
                 max_source_positions=20, max_target_positions=16)
    jcfg, cfg = JaxConfig(**small), WhisperConfig(**small)
    jp = jax_init_params(jcfg, seed=1)
    params = prepare_params(from_jax_params(jp, cfg), DtypePolicy.fp32(), "cpu")
    rng = np.random.RandomState(6)
    enc = rng.randn(2, 20, 128).astype(np.float32)
    tokens = rng.randint(0, 300, (2, 11)).astype(np.int32)
    calls = []
    real = M.decoder_attention

    def counted(q, k, v, causal):
        calls.append((causal, q.shape[1], k.shape[1]))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(M, "decoder_attention", counted)
    if route == "kernel":
        monkeypatch.setattr(M, "_decoder_kernel_applies", lambda q, plain_tril: plain_tril)
    want = JM.decode_train(jp, jnp.asarray(enc), jnp.asarray(tokens), jcfg, JaxPolicy.fp32())
    with torch.no_grad():
        got = M.decode_train(params, torch.from_numpy(enc), torch.from_numpy(tokens), cfg,
                             DtypePolicy.fp32())
        # a key mask keeps the plain path whatever the route
        masked = M.decode_train(params, torch.from_numpy(enc), torch.from_numpy(tokens), cfg,
                                DtypePolicy.fp32(), attention_mask=torch.ones(2, 11, dtype=bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    assert torch.equal(masked, got)
    assert calls == ([(True, 11, 11), (False, 11, 20)] * 2 if route == "kernel" else [])


def test_dec_attn_roofline_bound_and_wrapper(monkeypatch):
    """The benchmark's bound of the decoder attention counts the work the
    mask keeps (causal: S(S+1)/2 pairs, then bound by bytes at distill's
    shapes; cross: Sq x Sk, by operations); its wrapper adds the bound of
    each call made while a stretch is traced and passes ``causal`` on, and
    leaves a port without ``decoder_attention`` untouched."""
    from collections import defaultdict
    from types import SimpleNamespace

    from port_bench.roofline import dec_attn
    from taiwan_whisper_tpu_torch.models import whisper as M

    q = (32, 448, 20, 64)
    assert dec_attn.bound(q, q, True, 2) == pytest.approx(4 * 32 * 448 * 1280 * 2 / 3.35e12)
    assert dec_attn.bound(q, (32, 1500, 20, 64), False, 2) == pytest.approx(
        4 * 32 * 20 * 64 * 448 * 1500 / 989e12)
    long = (32, 1500, 20, 64)  # there the causal half is bound by operations
    assert dec_attn.bound(long, long, True, 2) == pytest.approx(
        4 * 32 * 20 * 64 * 1500 * 1501 / 2 / 989e12)

    calls = []
    stretch = SimpleNamespace(acc=defaultdict(float))
    patched = {}

    class Ctx:
        active = None

        def active_stretch(self):
            return self.active

        def patch(self, obj, attr, make):
            patched[attr] = make(getattr(obj, attr))

    ctx = Ctx()
    monkeypatch.setattr(M, "decoder_attention", lambda q, k, v, causal: calls.append(causal))
    dec_attn.install(ctx)
    wrapped = patched["decoder_attention"]
    t = torch.zeros(1, 3, 1, 64)
    wrapped(t, t, t, causal=True)  # no stretch traced: nothing added
    ctx.active = stretch
    wrapped(t, t, t, causal=True)
    wrapped(t, torch.zeros(1, 5, 1, 64), torch.zeros(1, 5, 1, 64), causal=False)
    assert calls == [True, True, False]
    assert stretch.acc["dec_attn"] == pytest.approx(
        dec_attn.bound(t.shape, t.shape, True, 4) + dec_attn.bound(t.shape, (1, 5, 1, 64), False, 4))
    monkeypatch.delattr(M, "decoder_attention")
    patched.clear()
    dec_attn.install(ctx)
    assert patched == {}
