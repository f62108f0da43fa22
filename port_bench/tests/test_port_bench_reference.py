"""The plain reference agrees with the port at a tiny size on the CPU, in
float32: log-mel, encoder, decoder, VAD regions and chunks, the decoding
rules, the training batches and three train steps."""

import os

import numpy as np
import pytest
import torch

from port_bench import synth
from port_bench import weights as W
from port_bench.reference import audio as A
from port_bench.reference import data as D
from port_bench.reference import model as RM
from port_bench.reference import rules as R
from port_bench.reference import train_check as TC

TINY = dict(vocab_size=51865, num_mel_bins=80, d_model=64, encoder_layers=2,
            encoder_attention_heads=2, encoder_ffn_dim=128, decoder_layers=2,
            decoder_attention_heads=2, decoder_ffn_dim=128, max_source_positions=1500,
            max_target_positions=448, decoder_start_token_id=50258, eos_token_id=50257,
            pad_token_id=50257, bos_token_id=50257)


@pytest.fixture(scope="module")
def tiny():
    from taiwan_whisper_tpu_torch.models.io import config_from_hf_dict
    from taiwan_whisper_tpu_torch.models.params import load_hf_state_dict

    sd = W.make_state_dict(TINY, 1234, "cpu", dtype=torch.float32)
    cfg = config_from_hf_dict(TINY)
    return sd, cfg, load_hf_state_dict(sd, cfg)


def _speech(seed, seconds):
    rng = np.random.RandomState(seed)
    return synth.with_noise_floor(rng, synth.synth_lecture(rng, seconds)[:int(seconds * 16000)],
                                  -50.0)


def test_log_mel():
    from taiwan_whisper_tpu_torch.audio.mel import log_mel

    audio = torch.from_numpy(np.stack([_speech(0, 30), _speech(1, 30)]))
    np.testing.assert_allclose(RM.log_mel(audio, 80).numpy(), log_mel(audio, 80).numpy(),
                               atol=2e-4)


def test_encoder_and_decoder(tiny):
    from taiwan_whisper_tpu_torch.models import whisper as M
    from taiwan_whisper_tpu_torch.models.config import DtypePolicy

    sd, cfg, params = tiny
    pol = DtypePolicy.fp32()
    mel = torch.randn(2, 3000, 80, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 51865, (2, 20), generator=torch.Generator().manual_seed(1))
    ref = RM.Whisper(sd, TINY)
    with torch.no_grad():
        enc_p = M.encode(params, mel, cfg, pol, remat=False)
        enc_r = ref.encode(mel)
        np.testing.assert_allclose(enc_r.numpy(), enc_p.float().numpy(), atol=2e-4, rtol=1e-4)
        lp = M.decode_train(params, enc_p, tokens, cfg, pol, remat=False)
        lr = ref.decode(enc_r, tokens)
    np.testing.assert_allclose(lr.numpy(), lp.numpy(), atol=2e-4, rtol=1e-4)


def test_vad_regions_and_chunks():
    from taiwan_whisper_tpu_torch.pipeline import label_resident as LR
    from taiwan_whisper_tpu_torch.pipeline import vad as V

    a = _speech(3, 250.0)
    i16 = synth.to_pcm16(a)
    f = i16.astype(np.float32) / 32768.0
    sc = V._scores_dict(V._score_segments(V._file_segments(f), "cpu"), len(f) / 16000)
    port = V.spectral_speech_regions(f, scores=sc)
    ref = A.corpus_regions([i16], "cpu")[0]
    assert len(ref) > 3
    np.testing.assert_allclose(np.asarray(ref), np.asarray(port), atol=1e-9)
    for n in (1000, 480000, 480001, 1200000, 2000000):
        got = [(s, v) for s, _, _, _, v in LR.chunk_spans(n, 480000, 80000, 80000)]
        assert A.chunk_spans(n, 480000, 80000) == got


def test_fingerprint_is_exact():
    rows = np.random.RandomState(0).randint(-32768, 32767, (3, 480000)).astype(np.int16)
    w = A.fingerprint_weights(5, 480000, "cpu")
    fp = A.fingerprint_i16(torch.from_numpy(rows), w)
    exact = [int(sum(int(x) * int(y) for x, y in zip(r[:2000], w[:2000].long().tolist())))
             for r in rows]
    part = A.fingerprint_i16(torch.from_numpy(rows[:, :2000]), w[:2000])
    assert part.tolist() == exact
    as_float = torch.from_numpy(rows).float() / 32768.0
    again = ((as_float.double() * 32768.0).round() @ w).round().long()
    assert again.tolist() == fp.tolist()


def test_rules_and_greedy_choice():
    from taiwan_whisper_tpu_torch.decode.rules import DecodeRules, _rule_mask, greedy_rules_argmax
    from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL

    rules = DecodeRules.from_special(MULTILINGUAL, timestamps=True)
    suppress = torch.from_numpy(rules.suppress_mask())
    begin = torch.from_numpy(rules.begin_suppress_mask())
    g = torch.Generator().manual_seed(0)
    prefix = [50258, 50260, 50359]
    served = [50364, 400, 500, 50400, 50400, 600, 50420, 50257]
    logits = torch.randn(len(served), 51865, generator=g) * 3
    logits[:, 50364:] += 2.0
    masks = R.rule_masks(prefix, served, 51865, "cpu")
    seq = prefix + served
    last_ts = 0
    for s in range(len(served)):
        i = len(prefix) + s
        state = dict(step=s, last_token=torch.tensor([seq[i - 1]]),
                     penult_token=torch.tensor([seq[max(i - 2, 0)]]),
                     last_timestamp=torch.tensor([last_ts]), rules=rules, suppress=suppress,
                     begin_suppress=begin)
        port_mask = _rule_mask(token_ids=torch.arange(51865)[None, :], **state)
        assert torch.equal(port_mask[0], masks[s]), s
        nxt, _ = greedy_rules_argmax(logits[s:s + 1], **state)
        assert int(nxt[0]) == int(R.greedy_picks(logits[s:s + 1], masks[s:s + 1])[0])
        if seq[i] >= 50364:
            last_ts = seq[i]
    picks = R.greedy_picks(logits, masks)
    assert torch.all(R.step_gaps(logits, masks, picks) == 0)
    gaps = R.step_gaps(logits, masks, torch.tensor(served))
    assert torch.all(gaps >= 0)


def test_training_batches(tmp_path):
    from taiwan_whisper_tpu_torch.audio.manifest import read_manifest
    from taiwan_whisper_tpu_torch.pipeline.dataset import TrainPrepConfig, train_batches
    from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer

    man = synth.segment_corpus(np.random.RandomState(7), str(tmp_path / "seg"), 24, 6, (2, 8),
                               -50.0)
    tok = WhisperTokenizer.from_pretrained_dir(synth.write_byte_tokenizer(str(tmp_path / "t")))
    prep = TrainPrepConfig(timestamp_probability=0.5, condition_on_prev_probability=0.5)
    port = list(train_batches(read_manifest(man), tok, prep, 4, seed=42))[:3]
    ref = D.batches(man, seed=42, batch_size=4, n=3, ts_prob=0.5, prev_prob=0.5)
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        for k in ("audio", "decoder_input_ids", "labels"):
            np.testing.assert_array_equal(p[k], r[k])


def test_three_train_steps(tmp_path, tiny):
    """The reference's three steps against the port's train step at fp32:
    losses, step-1 gradients and the change over the steps."""
    from taiwan_whisper_tpu_torch.models.config import DtypePolicy
    from taiwan_whisper_tpu_torch.models.params import named_leaves
    from taiwan_whisper_tpu_torch.ops.mel_kernel import log_mel
    from taiwan_whisper_tpu_torch.models.io import config_from_hf_dict
    from taiwan_whisper_tpu_torch.models.params import (init_student_from_teacher, load_hf_state_dict,
                                                        map_params, mix_language_embeddings)
    from taiwan_whisper_tpu_torch.train.distill import DistillConfig, make_train_step
    from taiwan_whisper_tpu_torch.train.state import OptimConfig, make_optimizer, trainable_mask

    sd, cfg, _ = tiny
    man = synth.segment_corpus(np.random.RandomState(8), str(tmp_path / "seg"), 16, 8, (2, 6),
                               -50.0)
    batches = D.batches(man, seed=42, batch_size=4, n=3, ts_prob=0.2, prev_prob=0.2)
    teacher = map_params(lambda _, t: t.float(), load_hf_state_dict(sd, cfg))
    teacher = mix_language_embeddings(teacher, TC.ZH, [TC.ZH, TC.EN])
    scfg = cfg.with_decoder_layers(1)
    student = init_student_from_teacher(teacher, cfg, 1)
    opt_cfg = OptimConfig(learning_rate=1e-3, warmup_steps=2)
    opt = make_optimizer(opt_cfg, mask=trainable_mask(student, True))
    dcfg = DistillConfig()
    step = make_train_step(scfg, cfg, dcfg, opt, DtypePolicy.fp32())
    state = opt.init(student)
    p0 = {k: v.clone() for k, v in named_leaves(student)}
    losses = []
    for i, b in enumerate(batches):
        tb = {"mel": log_mel(torch.from_numpy(b["audio"]), 80),
              "decoder_input_ids": torch.from_numpy(b["decoder_input_ids"]).int(),
              "labels": torch.from_numpy(b["labels"]).int()}
        student, state, metrics = step(student, state, {"decoder": teacher["decoder"]}, tb)
        losses.append(float(metrics["loss"]))
        if i == 0:
            mu1 = {k: v.clone() for k, v in state["mu"].items()}
    s_cfg = dict(TINY, decoder_layers=1)
    r_losses, g1, init, p3 = TC.reference_steps(
        sd, s_cfg, TINY, batches, dist=dict(ce_weight=0.8, kl_weight=1.0, temperature=2.0),
        opt=dict(learning_rate=1e-3, warmup_steps=2), mix=True, precision=RM.Precision(),
        device="cpu")
    np.testing.assert_allclose(losses, r_losses, rtol=2e-5)
    names = {TC.hf_name(k): k for k in mu1}
    assert set(names) == set(g1)
    for k, pk in names.items():
        np.testing.assert_allclose((mu1[pk] / (1 - TC.B1)).numpy(), g1[k].numpy(),
                                   atol=1e-6, rtol=1e-3)
        torch.testing.assert_close(p0[pk], init[k], atol=0, rtol=0)
        np.testing.assert_allclose(dict(named_leaves(student))[pk].detach().numpy(), p3[k].numpy(),
                                   atol=1e-6)
