"""The port's weight bridges: JAX pytree -> port layouts, HF names, and the
numpy safetensors reader/writer against the JAX package's checkpoints."""

import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.models.params import params_to_hf
from taiwan_whisper_tpu_torch.models.config import WhisperConfig
from taiwan_whisper_tpu_torch.models.io import (load_model, read_safetensors,
                                                save_hf_checkpoint)
from taiwan_whisper_tpu_torch.models.params import (from_jax_params, init_params,
                                                    num_params, prepare_params,
                                                    to_hf_state_dict)
from taiwan_whisper_tpu_torch.models.config import DtypePolicy

SMALL = dict(vocab_size=1000, d_model=64, ffn_dim=128, encoder_layers=2,
             decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
             max_source_positions=60, max_target_positions=32)


@pytest.fixture(scope="module")
def jax_model():
    cfg = JaxConfig(**SMALL)
    return jax_init_params(cfg, seed=0), cfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def test_from_jax_params_matches_tensor_for_tensor(jax_model):
    jp, jcfg = jax_model
    cfg = WhisperConfig(**SMALL)
    port = from_jax_params(jp, cfg)
    enc, dec = jp["encoder"], jp["decoder"]
    np.testing.assert_array_equal(port["encoder"]["conv1"]["weight"].numpy(),
                                  np.transpose(np.asarray(enc["conv1"]["kernel"]), (2, 1, 0)))
    np.testing.assert_array_equal(port["decoder"]["embed_tokens"].numpy(),
                                  np.asarray(dec["embed_tokens"]))
    for i in range(cfg.decoder_layers):
        lp = port["decoder"]["layers"][i]
        for name in ("q", "k", "v", "out"):
            np.testing.assert_array_equal(
                lp["cross_attn"][name]["weight"].numpy(),
                np.asarray(dec["layers"]["cross_attn"][name]["kernel"][i]).T)
        assert "bias" not in lp["self_attn"]["k"]
        np.testing.assert_array_equal(lp["final_ln"]["weight"].numpy(),
                                      np.asarray(dec["layers"]["final_ln"]["scale"][i]))
    # every tensor also equals the HF-named export of the JAX package
    hf = params_to_hf(jp, jcfg)
    ours = {k: v.numpy() for k, v in to_hf_state_dict(port).items()}
    assert set(ours) == set(hf) - {"proj_out.weight"}
    for k, v in ours.items():
        np.testing.assert_array_equal(v, hf[k], err_msg=k)


def test_safetensors_reader_returns_what_jax_wrote(tmp_path, jax_model):
    jp, jcfg = jax_model
    d = str(tmp_path / "jax_ckpt")
    jax_save(d, jp, jcfg)
    got = read_safetensors(f"{d}/model.safetensors")
    hf = params_to_hf(jp, jcfg)
    hf.pop("proj_out.weight")
    assert set(got) == set(hf)
    for k, v in hf.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    params, cfg = load_model(d)
    assert cfg == WhisperConfig(**SMALL)
    ref = dict(_flat(from_jax_params(jp, cfg)))
    for k, v in _flat(params):
        assert torch.equal(v, ref[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_and_format(tmp_path, dtype):
    """The port's writer round-trips bit-exactly (bf16 as 16-bit words) and
    writes files the safetensors library itself reads."""
    safetensors_torch = pytest.importorskip("safetensors.torch")
    cfg = WhisperConfig(**SMALL)
    params = init_params(cfg, seed=3, dtype=dtype)
    d = str(tmp_path / "ckpt")
    save_hf_checkpoint(d, params, cfg)
    back, cfg2 = load_model(d)
    assert cfg2 == cfg
    ref = dict(_flat(params))
    for k, v in _flat(back):
        assert v.dtype == dtype and torch.equal(v, ref[k]), k
    lib = safetensors_torch.load_file(f"{d}/model.safetensors")
    for k, v in to_hf_state_dict(params).items():
        assert torch.equal(lib[k], v), k


def test_init_params_layout_and_prepare():
    cfg = WhisperConfig(**SMALL)
    a, b = init_params(cfg, seed=0), init_params(cfg, seed=0)
    jshapes = {k: tuple(v.shape) for k, v in
               _flat(from_jax_params(jax_init_params(JaxConfig(**SMALL)), cfg))}
    for k, v in _flat(a):
        assert tuple(v.shape) == jshapes[k], k
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_flat(a), _flat(b)))
    prepared = prepare_params(a, DtypePolicy(), "cpu")
    assert prepared["decoder"]["layers"][0]["fc1"]["weight"].dtype == torch.bfloat16
    assert prepared["decoder"]["layers"][0]["final_ln"]["weight"].dtype == torch.float32
    assert prepared["encoder"]["ln_post"]["bias"].dtype == torch.float32
    assert num_params(prepared) == num_params(a)


@pytest.mark.parametrize("kw", [dict(decoder_layers=1), dict(decoder_layers=2, encoder_layers=1),
                                dict(decoder_layers=2, decoder_layer_indices=[1, 0])])
def test_init_student_from_teacher_matches_jax(jax_model, kw):
    from taiwan_whisper_tpu.models.params import init_student_from_teacher as jax_student
    from taiwan_whisper_tpu_torch.models.params import init_student_from_teacher

    jp, jcfg = jax_model
    cfg = WhisperConfig(**SMALL)
    n = kw["decoder_layers"]
    scfg = cfg.with_decoder_layers(n)
    if "encoder_layers" in kw:
        scfg = scfg.with_encoder_layers(kw["encoder_layers"])
    teacher = from_jax_params(jp, cfg)
    got = init_student_from_teacher(teacher, cfg, n, kw.get("decoder_layer_indices"),
                                    encoder_layers=kw.get("encoder_layers"))
    ref = dict(_flat(from_jax_params(
        jax_student(jp, jcfg, n, kw.get("decoder_layer_indices"),
                    encoder_layers=kw.get("encoder_layers")), scfg)))
    flat = dict(_flat(got))
    assert set(flat) == set(ref)
    for k, v in flat.items():
        assert torch.equal(v, ref[k]), k
        assert all(v.data_ptr() != t.data_ptr() for _, t in _flat(teacher)), k  # copies


def test_mix_language_embeddings_matches_jax(jax_model):
    from taiwan_whisper_tpu.models.params import mix_language_embeddings as jax_mix
    from taiwan_whisper_tpu_torch.models.params import mix_language_embeddings

    jp, _ = jax_model
    port = from_jax_params(jp, WhisperConfig(**SMALL))
    before = port["decoder"]["embed_tokens"].clone()
    for weights in (None, [0.25, 0.75]):
        got = mix_language_embeddings(port, 7, [7, 9], weights)["decoder"]["embed_tokens"]
        ref = np.asarray(jax_mix(jp, 7, [7, 9], weights)["decoder"]["embed_tokens"])
        np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(port["decoder"]["embed_tokens"], before)  # input untouched


def test_layer_index_maps_match_jax():
    from taiwan_whisper_tpu.models import params as JP
    from taiwan_whisper_tpu_torch.models import params as TP

    for t, s in ((32, 2), (32, 3), (24, 4), (2, 1), (6, 6)):
        assert TP.spaced_layer_indices(t, s) == JP.spaced_layer_indices(t, s)
        assert TP.layers_to_supervise(s, t) == JP.layers_to_supervise(s, t)
