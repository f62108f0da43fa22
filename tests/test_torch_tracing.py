"""The port's spans and counters (``utils/profiling.py``): after a tiny
greedy, sampled and beam decode, a ``label_files`` run on both pooled
routes and a train step on the CPU, each span and counter is there with
counts that agree (a select and a step for every loop iteration, a poll
every 8); the label stats' seconds are their spans' seconds; no
``record_function`` is entered while no profiler records; under
``profiling.trace`` the ``tw:`` ranges lie in the Chrome trace, nested as
the code nests them; and spans and counters on worker threads lose
nothing."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from taiwan_whisper_tpu_torch.audio.io import write_wav
from taiwan_whisper_tpu_torch.decode.beam import beam_decode
from taiwan_whisper_tpu_torch.decode.greedy import greedy_decode
from taiwan_whisper_tpu_torch.decode.rules import DecodeRules
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import init_params, prepare_params
from taiwan_whisper_tpu_torch.pipeline import label as PL
from taiwan_whisper_tpu_torch.pipeline.label import LabelConfig, label_files
from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL, WhisperTokenizer
from taiwan_whisper_tpu_torch.tools.synth_audio import synth_lecture
from taiwan_whisper_tpu_torch.train.distill import DistillConfig, make_train_step
from taiwan_whisper_tpu_torch.train.state import OptimConfig, make_optimizer, trainable_mask
from taiwan_whisper_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128, encoder_layers=1,
            decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
            max_source_positions=60, max_target_positions=48)
FP32 = DtypePolicy.fp32()
STEPS = 20  # decode budget: 20 // 8 == (20 - 1) // 8, as greedy and beam poll


@pytest.fixture(scope="module")
def tiny():
    cfg = WhisperConfig(**TINY)
    return prepare_params(init_params(cfg, seed=0), FP32, "cpu"), cfg


def _decode(kind, params, cfg):
    enc = torch.from_numpy(np.random.RandomState(3).randn(4, 60, 64).astype(np.float32))
    sot = WhisperTokenizer().sot_sequence("zh", "transcribe", timestamps=True)
    prefix = torch.tensor([sot] * 4, dtype=torch.int32)
    rules = DecodeRules.from_special(MULTILINGUAL)
    kw = dict(max_len=len(sot) + STEPS, device="cpu")
    if kind == "beam":
        return beam_decode(params, enc, prefix, cfg, rules, FP32, num_beams=2, **kw)
    return greedy_decode(params, enc, prefix, cfg, rules, FP32,
                         temperature=0.0 if kind == "greedy" else 1.0, **kw)


@pytest.mark.parametrize("kind", ["greedy", "sampled", "beam"])
def test_decode_spans_and_counters_agree(tiny, kind):
    snap = profiling.snapshot()
    res = _decode(kind, *tiny)
    got = profiling.since(snap)
    spans, counts = got["spans"], got["counts"]
    assert 0 < res.steps <= STEPS
    for name in ("decode.cross_kv", "decode.prefill", "decode.loop"):
        assert spans[name]["calls"] == 1, name
    assert spans["decode.select"]["calls"] == spans["decode.step"]["calls"] == res.steps
    assert counts["decode.steps"] == res.steps
    assert counts["decode.row_steps"] == res.steps * 4  # the batch's items
    assert spans.get("decode.poll", {"calls": 0})["calls"] == res.steps // 8
    inner = sum(spans[n]["seconds"] for n in ("decode.select", "decode.step")
                if n in spans)
    assert 0 < inner <= spans["decode.loop"]["seconds"]


def test_live_row_steps():
    # a row that ended at its k-th token served k + 1 steps (its eot's
    # too); one that never ended served every step
    assert PL.live_row_steps(np.array([0, 3, 7, 9]), 8) == 1 + 4 + 8 + 8


@pytest.fixture(scope="module")
def lectures(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing_lectures")
    rng = np.random.RandomState(5)
    paths = []
    for i, secs in enumerate((20.0, 30.0)):
        paths.append(str(d / f"lec{i}.wav"))
        write_wav(paths[-1], synth_lecture(rng, secs))
    return paths


ROUTES = {"resident": dict(vad_mode="spectral"),
          "chunks": dict(wire_mode="chunks", vad_mode="spectral-device")}
WAITS = {"resident": ("label.upload_wait", "upload_wait_s"),
         "chunks": ("label.stage_wait", "stage_wait_s")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_label_stats_are_their_spans(tmp_path, tiny, lectures, route, monkeypatch):
    params, cfg = tiny
    results = []

    def spy(*a, **kw):
        results.append(orig(*a, **kw))
        return results[-1]

    orig = PL.decode_audio
    monkeypatch.setattr(PL, "decode_audio", spy)
    bs = 4
    stats = label_files(params, cfg, WhisperTokenizer(MULTILINGUAL), lectures,
                        str(tmp_path / "out"), LabelConfig(batch_size=bs, max_decode_tokens=12,
                                                           **ROUTES[route]),
                        FP32, device="cpu", log_every=0)
    spans, counts = stats["spans"], stats["counts"]
    assert stats["files"] == 2 and stats["batches"] == len(results) > 1
    assert ("groups" in stats) == (route == "resident")
    keys = [("label.load_wait", "load_wait_s"), ("label.vad", "vad_s"),
            ("label.scatter", "scatter_s"), WAITS[route]]
    for name, key in keys:
        assert spans[name]["seconds"] == pytest.approx(stats[key], rel=1e-9, abs=1e-12), name
    decode = spans["label.decode"]["seconds"] + spans["label.fetch"]["seconds"]
    assert decode == pytest.approx(stats["decode_s"], rel=1e-9)
    assert spans["label.decode"]["calls"] == spans["label.fetch"]["calls"] == stats["batches"]
    for name in ("decode.mel", "decode.encode", "decode.loop"):
        assert spans[name]["calls"] == stats["batches"], name
    steps = sum(r.steps for r in results)
    assert counts["decode.steps"] == spans["decode.step"]["calls"] == steps
    assert counts["decode.row_steps"] == steps * bs
    # every real row is live at its first step, and pad rows count in
    # row_steps alone
    assert stats["chunks"] <= counts["label.live_row_steps"] <= counts["decode.row_steps"]
    if route == "chunks":  # whole batches, then the rest: the real rows are known
        real = [min(bs, stats["chunks"] - i * bs) for i in range(len(results))]
        assert counts["label.live_row_steps"] == sum(
            PL.live_row_steps(r.lengths.numpy()[:n], r.steps) for r, n in zip(results, real))


class _Counted(torch.profiler.record_function):
    entered = 0

    def __enter__(self):
        type(self).entered += 1
        return super().__enter__()


def test_no_record_function_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counted)
    _Counted.entered = 0
    d = {"s": 0.0}
    for _ in range(100):
        with profiling.span("t.off", d, "s"):
            pass
    assert _Counted.entered == 0 and d["s"] > 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("t.on"):
            pass
    assert _Counted.entered == 1


def test_tw_ranges_nest_in_the_chrome_trace(tmp_path, tiny):
    with profiling.trace(str(tmp_path)):
        res = _decode("greedy", *tiny)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"], e["tid"]))
    (loop,) = by["tw:decode.loop"]
    assert len(by["tw:decode.step"]) == len(by["tw:decode.select"]) == res.steps
    for a, b, tid in by["tw:decode.step"] + by["tw:decode.select"]:
        assert loop[0] <= a and b <= loop[1] and tid == loop[2]
    assert "tw:decode.cross_kv" in by and "tw:decode.prefill" in by


def test_worker_threads_lose_nothing():
    """More threads than cores, switching as often as the interpreter
    allows: a lost update would show in the totals."""
    snap = profiling.snapshot()
    n, threads = 2000, 2 * (os.cpu_count() or 8)
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=60)
        for _ in range(n):
            with profiling.span("t.worker"):
                profiling.count("t.items", 3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    got = profiling.since(snap)
    assert got["spans"]["t.worker"]["calls"] == n * threads
    assert got["spans"]["t.worker"]["seconds"] > 0
    assert got["counts"] == {"t.items": 3 * n * threads}
    assert set(got["spans"]) == {"t.worker"}  # since() names only what moved


def test_train_step_spans(tiny):
    _, cfg = tiny
    student = init_params(cfg.with_decoder_layers(1), seed=1)
    teacher = {"decoder": init_params(cfg, seed=2)["decoder"]}
    dcfg = DistillConfig()
    opt = make_optimizer(OptimConfig(warmup_steps=0),
                         mask=trainable_mask(student, dcfg.freeze_encoder))
    step = make_train_step(cfg.with_decoder_layers(1), cfg, dcfg, opt, FP32)
    rng = np.random.RandomState(0)
    labels = torch.from_numpy(rng.randint(0, 1000, (2, 6)))
    labels[:, :2] = -100
    batch = {"mel": torch.from_numpy(rng.randn(2, 120, 80).astype(np.float32)),
             "decoder_input_ids": torch.from_numpy(rng.randint(0, 1000, (2, 6))),
             "labels": labels}
    snap = profiling.snapshot()
    state = opt.init(student)
    for _ in range(2):
        student, state, _ = step(student, state, teacher, batch)
    spans = profiling.since(snap)["spans"]
    names = ("train.encode", "train.student", "train.teacher", "train.backward",
             "train.optimizer")
    assert set(spans) == set(names)
    assert all(spans[n]["calls"] == 2 for n in names)
