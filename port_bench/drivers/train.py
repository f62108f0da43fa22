"""Window driver of the training entry points,
``pipeline/distill_driver.py::run_distillation`` and ``run_finetuning``.

The port's own driver runs: its set-up, its prefetch thread, its log-mel
on the device, its train step, its logging cadence. The benchmark gives it
seeded weights without a checkpoint on disk (``distill_driver.load_model``
returns them, built on the device by ``weights.py`` and handed through
``models/params.py::load_hf_state_dict``), a seeded segment manifest and a
byte-level tokenizer. Three wrappers stay in place for the run:

* ``make_train_step``: the step it makes counts its calls. Steps 1-3 are
  set-up (the reference follows them: this driver keeps their losses, the
  trainable leaves before step 1 and after step 3, and step 1's AdamW
  first moments); the window opens at the start of step 4 and closes at
  the synchronisation after the first step that ends ``--seconds`` after
  it, by raising out of the loop before the next step: no checkpoint is
  written (the shipped save and eval cadence, every 1000 steps, lies far
  beyond the window);
* ``prefetch``: each ``next()`` into the data layer is timed (the
  window's data wait) and the first three host batches are kept;
* in a ``--trace 1`` run each step of the ``step`` stretch
  (``trace.steps`` steps from window step ``trace.from``) runs in a
  ``bench:step`` range.

Each window step's start is marked, and so is the window's close: the
host clock, a CUDA event on the current stream (recorded, and read only
once the window has closed: nothing waits on it inside), and the running
totals of the port's spans and of the data wait. ``host.snapshot`` reads
the CPU time of the process's threads as the window opens and after it
closes, and a ``card.Sampler`` reads the card's clock, power,
temperature and throttle reasons every ``CARD_PERIOD_S`` from the
window's opening. After the window the driver prints what they say
(``_Steps.window``) as one ``port_bench.train`` JSON line on standard
error.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from port_bench import card, harness, host, synth
from port_bench import weights as W
from port_bench.reference import train_check
from port_bench.roofline import whisper_flops as F
from port_bench.trace import STEP_RANGE

WARM_STEPS = 3
CARD_PERIOD_S = 0.5  # between two readings of the card (card.Sampler)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy: what the benchmark keeps takes no device memory."""
    return t.detach().to("cpu", copy=True)


def _spans() -> dict:
    """The port's span totals so far (``utils/profiling.py::snapshot``):
    ``{name: (calls, host seconds)}``."""
    from taiwan_whisper_tpu_torch.utils import profiling

    return profiling.snapshot()["spans"]


class WindowClosed(Exception):
    """Raised out of the port's train loop when the window ends."""


class _Steps:
    def __init__(self, ctx, t_start: float):
        self.ctx = ctx
        self.t_start = t_start
        self.tr = ctx.traffic.get("trace", {})
        self.cuda = ctx.device.type == "cuda"
        self.n = 0
        self.batches = []
        self.losses = []
        self.mu1 = self.p0 = self.p3 = None
        self.data_wait = 0.0
        self.in_window = False
        self.t0 = self.t1 = 0.0
        # each window step's start, then the window's close: (host clock,
        # CUDA event, the port's span totals, data wait so far)
        self.marks = []
        self.returns = []  # the host clock as each window step's call returns
        self.snaps = []  # host.snapshot as the window opens and after it closes
        self.card = None
        self.setup_s = None
        self.traced = 0

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.ctx.device)

    def _mark(self, t: float):
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self.marks.append((t, ev, _spans(), self.data_wait))

    def close(self):
        if self.card is not None:
            self.card.close()

    def prefetch(self, orig):
        def wrapped(iterable, buffer_size=2):
            it = orig(iterable, buffer_size)

            def gen():
                while True:
                    t = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    self.data_wait += time.perf_counter() - t
                    if len(self.batches) < WARM_STEPS:
                        self.batches.append(batch)
                    yield batch
            return gen()
        return wrapped

    def make_train_step(self, orig, trainable_paths, named_leaves, freeze: bool):
        def make(*args, **kwargs):
            step = orig(*args, **kwargs)

            def train_step(student, opt_state, teacher, batch):
                self.n += 1
                if self.n == 1:
                    train = set(trainable_paths(student, freeze))
                    self.p0 = {p: _host(t) for p, t in named_leaves(student) if p in train}
                if self.n == WARM_STEPS + 1:
                    self._sync()
                    if self.cuda:
                        torch.cuda.reset_peak_memory_stats(self.ctx.device)
                    harness.settle(self.ctx.device)
                    self.setup_s = time.time() - self.t_start
                    self.card = card.Sampler(self.ctx.device, CARD_PERIOD_S)
                    harness.pin_launcher()  # its thread off the launcher's core
                    self.snaps.append(host.snapshot())
                    self.in_window = True
                    self.t0 = time.perf_counter()
                if self.in_window:
                    self._mark(time.perf_counter())
                k = self.n - WARM_STEPS  # window step, from 1
                s = self.ctx.stretch("step")
                if self.ctx.trace and s.wanted and k >= self.tr.get("from", 4):
                    s.start()
                    self.traced = 0
                if s.active:
                    with torch.profiler.record_function(STEP_RANGE):
                        out = step(student, opt_state, teacher, batch)
                    self.traced += 1
                    if self.traced >= self.tr.get("steps", 3):
                        s.stop()
                else:
                    out = step(student, opt_state, teacher, batch)
                if self.in_window:
                    self.returns.append(time.perf_counter())
                if self.n <= WARM_STEPS:
                    self.losses.append(out[2]["loss"].detach())
                if self.n == 1:
                    self.mu1 = {p: _host(out[1]["mu"][p]) for p in self.p0}
                if self.n == WARM_STEPS:
                    self.p3 = {p: _host(t) for p, t in named_leaves(out[0]) if p in self.p0}
                if self.in_window and time.perf_counter() - self.t0 >= self.ctx.seconds:
                    if s.active:
                        s.stop()
                    self._mark(0.0)
                    self._sync()
                    self.t1 = time.perf_counter()
                    self.marks[-1] = (self.t1,) + self.marks[-1][1:]
                    self.snaps.append(host.snapshot())
                    self.in_window = False
                    raise WindowClosed
                return out
            return train_step
        return make

    def window(self) -> dict:
        """What the marks and the readings say, read once the window has
        closed: each step's time (between its start's CUDA event and the
        next one's), the host time of its call and of its upload, the data
        wait, the host time a step of each of the port's spans, the CPU
        time of the process's threads (``host.delta``), and the card."""
        m = self.marks
        pairs = list(zip(m, m[1:]))
        up = [1e3 * (b[2].get("train.upload", (0, 0.0))[1] - a[2].get("train.upload", (0, 0.0))[1])
              for a, b in pairs]
        out = {"step_ms": [round(a[1].elapsed_time(b[1]), 3) for a, b in pairs]
               if self.cuda else [],
               "launch_ms": [round(1e3 * (r - a[0]), 3) for (a, _), r in zip(pairs, self.returns)],
               "upload_ms": [round(x, 3) for x in up], "data_wait_s": m[-1][3] - m[0][3],
               "span_ms": {}, "host": host.delta(*self.snaps),
               "card": self.card.between(self.t0, self.t1)}
        for name, (calls, secs) in m[-1][2].items():
            c0, s0 = m[0][2].get(name, (0, 0.0))
            if calls != c0:
                out["span_ms"][name] = round(1e3 * (secs - s0) / len(pairs), 3)
        return out


def run(ctx, *, t_start: float) -> dict:
    from taiwan_whisper_tpu_torch.models.config import DtypePolicy
    from taiwan_whisper_tpu_torch.models.io import config_from_hf_dict
    from taiwan_whisper_tpu_torch.models.params import load_hf_state_dict, named_leaves
    from taiwan_whisper_tpu_torch.pipeline import distill_driver as DD
    from taiwan_whisper_tpu_torch.pipeline.dataset import TrainPrepConfig
    from taiwan_whisper_tpu_torch.train.distill import DistillConfig, trainable_paths
    from taiwan_whisper_tpu_torch.train.state import OptimConfig

    tr, dev = ctx.traffic, ctx.device
    distill = tr["mode"] == "distill"
    student_cfg = ctx.config
    teacher_cfg = None
    if distill:
        entry = next(c for c in ctx.plan.bench["configs"] if c["name"] == tr["teacher"])
        teacher_cfg = harness.read_json(ctx.plan.root, entry["file"])
    src_cfg = teacher_cfg if distill else student_cfg
    hf = W.hf_config(src_cfg)
    sd = W.make_state_dict(hf, ctx.torch_seed("weights"), dev)
    models = {"weights": (sd, config_from_hf_dict(hf))}

    def load_model(path):
        sd_, cfg_ = models[path]
        return load_hf_state_dict(sd_, cfg_), cfg_

    seg = tr["segments"]
    manifest = synth.segment_corpus(ctx.rng("segments"), os.path.join(ctx.workdir, "segments"),
                                    seg["n"], seg["pool"], tuple(seg["seconds"]),
                                    seg["noise_dbfs"])
    tok_dir = synth.write_byte_tokenizer(os.path.join(ctx.workdir, "tokenizer"))
    steps = _Steps(ctx, t_start)
    ctx.patch(DD, "load_model", lambda _: load_model)
    ctx.patch(DD, "prefetch", steps.prefetch)
    ctx.patch(DD, "make_train_step",
              lambda orig: steps.make_train_step(orig, trainable_paths, named_leaves,
                                                 tr["freeze_encoder"]))

    run_cfg = DD.DistillRunConfig(
        max_steps=tr["max_steps"], batch_size=tr["batch_size"], save_steps=tr["save_steps"],
        eval_steps=tr["eval_steps"], logging_steps=tr["logging_steps"], seed=tr["seed"],
        mix_lang_embeddings=distill)
    opt_cfg = OptimConfig(learning_rate=tr["learning_rate"], warmup_steps=tr["warmup_steps"],
                          total_steps=tr["max_steps"], schedule=tr["lr_schedule"])
    prep = TrainPrepConfig(language=tr["language"],
                           timestamp_probability=tr["timestamp_probability"],
                           condition_on_prev_probability=tr["condition_on_prev_probability"])
    out_dir = os.path.join(ctx.workdir, "out")
    policy = DtypePolicy.bf16()
    try:
        if distill:
            DD.run_distillation(
                manifest, "weights", out_dir,
                student_decoder_layers=student_cfg["decoder_layers"], run_cfg=run_cfg,
                dcfg=DistillConfig(ce_weight=tr["ce_weight"], kl_weight=tr["kl_weight"],
                                   temperature=tr["temperature"],
                                   freeze_encoder=tr["freeze_encoder"]),
                opt_cfg=opt_cfg, prep_cfg=prep, tokenizer_dir=tok_dir, policy=policy,
                device=dev)
        else:
            DD.run_finetuning(manifest, "weights", out_dir, freeze_encoder=tr["freeze_encoder"],
                              run_cfg=run_cfg, opt_cfg=opt_cfg, prep_cfg=prep,
                              tokenizer_dir=tok_dir, policy=policy, device=dev)
    except WindowClosed:
        pass
    finally:
        steps.close()
    if steps.t1 == 0.0:
        raise RuntimeError("the train loop ended before the window closed")
    window_s = steps.t1 - steps.t0
    n_window = steps.n - WARM_STEPS
    samples = n_window * tr["batch_size"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    tokens = tr["max_label_length"] - 1
    flops = samples * F.train_sample_flops(student_cfg, teacher_cfg, tokens=tokens)
    win = steps.window()
    print("port_bench.train " + json.dumps(win), file=sys.stderr, flush=True)
    record = dict(window_s=window_s, data_wait_s=win["data_wait_s"], peak_bytes=peak,
                  model_flops=flops, steps=n_window, card=win["card"])
    prog = dict(batches=steps.batches, losses=[float(x) for x in steps.losses],
                mu1=steps.mu1, p0=steps.p0, p3=steps.p3)
    models.clear()

    def check(control: bool = False):
        return train_check.check(
            sd=sd, student_cfg=student_cfg, teacher_cfg=teacher_cfg, manifest=manifest,
            prog=prog, data=dict(seed=tr["seed"], batch_size=tr["batch_size"],
                                 timestamp_probability=tr["timestamp_probability"],
                                 condition_on_prev_probability=tr[
                                     "condition_on_prev_probability"]),
            dist=dict(ce_weight=tr["ce_weight"], kl_weight=tr["kl_weight"],
                      temperature=tr["temperature"]),
            opt=dict(learning_rate=tr["learning_rate"], warmup_steps=tr["warmup_steps"]),
            mix=distill, limits=tr["limits"], device=dev, control=control)

    return {"e2e": {"train_samples_per_s": samples / window_s, "setup_s": steps.setup_s},
            "attempted": n_window, "record": record, "check": check}
