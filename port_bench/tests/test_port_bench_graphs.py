"""CUDA graphs in a traced run (``trace.Graphs``): on the CPU, with a stand-in
for ``torch.cuda.CUDAGraph``, a capture is recorded under its own Kineto
session or inside the stretch being traced, with the bounds the range
wrappers reckoned in it, each replay is marked, and the label driver counts
a replay of a graph that captured decode steps as those steps. On the card
(``python3 -m pytest port_bench/tests -m card``), the port's
``models/whisper.py::decode_step`` at the label cell's shapes, captured as
one graph and replayed, reads as its eager steps do."""

import json
import os

import pytest
import torch

from port_bench import harness, spans
from port_bench import trace as T

LABEL = "label.large-v2.greedy"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Graph:
    """What the wrappers need of ``torch.cuda.CUDAGraph``; runs nothing."""

    def capture_begin(self, *args, **kwargs):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.fixture
def ctx(tiny_root):
    c = harness.Ctx(harness.plan(tiny_root, LABEL), seed=3000000029, seconds=1.0, trace=True,
                    device=torch.device("cpu"), workdir=tiny_root)
    cls = type("Graph", (_Graph,), {})
    c.graphs = T.Graphs(c)
    c.graphs.install(cls)
    c.graph_cls = cls
    yield c
    c.unpatch()


def _capture_a_step(ctx, graph):
    from taiwan_whisper_tpu_torch.utils.profiling import span

    graph.capture_begin()
    assert ctx.capturing() is not None and ctx.active_stretch() is ctx.capturing()
    with span("decode.step"):
        ctx.active_stretch().acc["cross_attn"] += 1.5
        with torch.profiler.record_function("bench:cross_attn"):
            pass
    graph.capture_end()


def test_a_capture_is_recorded_under_its_own_session(ctx):
    graph = ctx.graph_cls()
    _capture_a_step(ctx, graph)
    assert ctx.capturing() is None and not T._profiling()
    assert T.graph_id(graph) == "0"
    # the CPU makes no node call; the ranges and the bound are kept
    assert ctx.graphs.records["0"] == {"acc": {"cross_attn": 1.5}, "nodes": [],
                                       "calls": {"tw:decode.step": 1, "bench:cross_attn": 1}}


def test_a_capture_inside_a_stretch_is_read_when_it_stops(ctx):
    s = ctx.stretch("loop")
    assert s.graphs is ctx.graphs
    s.start()
    graph = ctx.graph_cls()
    _capture_a_step(ctx, graph)
    assert "nodes" not in ctx.graphs.records["0"]
    assert ctx.active_stretch() is s
    graph.replay()
    s.stop()
    assert ctx.graphs.records["0"]["calls"] == {"tw:decode.step": 1, "bench:cross_attn": 1}
    assert s.result is not None and "graphs" not in s.result  # the CPU launched no graph


def test_a_replay_is_marked_while_a_profiler_records(ctx, tmp_path):
    graph = ctx.graph_cls()
    _capture_a_step(ctx, graph)
    graph.replay()  # no profiler: no range
    T._kineto_start(ctx.device)
    graph.replay()
    events = T._kineto_stop(str(tmp_path / "replay.json"))
    assert [e["name"] for e in events if e.get("cat") == "user_annotation"] == ["bench.replay:0"]


def test_the_label_driver_counts_a_replayed_step(ctx):
    tr = ctx.traffic["trace"]
    first, n = tr["loop_from"], tr["loop_steps"]
    cap = harness.load_driver(ctx.plan)._Capture(ctx, 16)
    ctx.patch(ctx.graph_cls, "replay", cap.replay)
    cap.recording = True
    cap.batches = [None] * tr["batch"]
    decode_step = cap.decode_step(lambda: None)
    graph = ctx.graph_cls()
    graph.capture_begin()
    decode_step()  # marked, and no stretch starts inside a capture
    graph.capture_end()
    assert cap.graph_steps == {"0": 1} and cap.step_in_batch == 0
    cap.step_in_batch = first - 2
    loop = ctx.stretch("loop")
    for i in range(n + 2):
        graph.replay()
        assert loop.active == (2 <= i < n + 1), i
    assert loop.result is not None and loop.tries == 1
    assert cap.step_in_batch == first + n


def _config(plan):
    from taiwan_whisper_tpu_torch.models.io import config_from_hf_dict
    from port_bench import weights as W

    hf = W.hf_config(plan.config)
    return hf, config_from_hf_dict(hf)


@pytest.mark.card
def test_a_replayed_decode_step_reads_as_its_eager_steps(card, tmp_path):
    """``decode_step`` of ``whisper-large-v2`` at b32 with fp8 cross K/V, at
    one position, with the cell's cross attention wrapper and step mark:
    16 eager steps traced, then the step captured as one graph and 16
    replays traced. The replays' cross attention holds as many kernels,
    within 10% of the device time and roofline share, and each step is one
    launch call."""
    from taiwan_whisper_tpu_torch.models import whisper as M
    from taiwan_whisper_tpu_torch.models.config import DtypePolicy
    from taiwan_whisper_tpu_torch.models.params import load_hf_state_dict, prepare_params
    from taiwan_whisper_tpu_torch.utils.profiling import span
    from port_bench import weights as W

    plan = harness.plan(ROOT, LABEL)
    ctx = harness.Ctx(plan, seed=3000000031, seconds=1.0, trace=True, device=card,
                      workdir=str(tmp_path))
    mods = harness.load_metrics(plan)
    lc, tr = plan.traffic["label"], plan.traffic["trace"]
    first, n = tr["loop_from"], tr["loop_steps"]
    with torch.inference_mode():  # as the greedy loop runs
        try:
            T.watch_graphs(ctx)
            spans.install(ctx)
            for m in mods.values():
                if hasattr(m, "install"):
                    m.install(ctx)
            hf, config = _config(plan)
            policy = DtypePolicy.bf16()
            params = prepare_params(load_hf_state_dict(
                W.make_state_dict(hf, ctx.torch_seed("weights"), card), config), policy, card)
            b = lc["batch_size"]
            gen = torch.Generator(device=card).manual_seed(ctx.torch_seed("inputs"))
            enc = torch.randn(b, config.max_source_positions, config.d_model, generator=gen,
                              device=card).to(torch.bfloat16)
            cross = M.precompute_cross_kv(params, enc, config, policy, quantize=lc["quantize_kv"])
            index = 3 + first  # the sot sequence, then the first traced step
            cache = M.init_cache(params, config, b, index + lc["max_decode_tokens"],
                                 dtype=policy.compute_dtype, device=card)
            token = torch.randint(0, config.vocab_size - 1000, (b,), generator=gen, device=card,
                                  dtype=torch.int32)
            cap = harness.load_driver(plan)._Capture(ctx, 16)
            ctx.patch(M, "decode_step", cap.decode_step)
            ctx.patch(torch.cuda.CUDAGraph, "replay", cap.replay)
            cap.recording = True
            cap.batches = [None] * tr["batch"]

            def step():
                with span("decode.step"):
                    return M.decode_step(params, cross, cache, token, index, config, policy)

            def take(run):
                """Two steps, then the loop stretch over ``n`` steps."""
                ctx.stretches.pop("loop", None)
                cap.step_in_batch = first - 2
                for _ in range(n + 2):
                    run()
                torch.cuda.synchronize(card)
                return ctx.stretch("loop").result

            eager_logits = step().clone()
            eager = take(step)
            side = torch.cuda.Stream(card)
            side.wait_stream(torch.cuda.current_stream(card))
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream(card).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                logits = step()
            graphed = take(graph.replay)
            graph_gap = (logits - eager_logits).abs().max().item()
        finally:
            ctx.unpatch()

    def read(red):
        rec = {"trace": {"loop": red}}
        c = red["ranges"]["cross_attn"]
        return {"cross_kernels": c["kernels"], "cross_calls": c["calls"],
                "cross_device_ms_a_step": 1e3 * c["device_s"] / n,
                "cross_bound_ms_a_step": 1e3 * red["acc"]["cross_attn"] / n,
                "roofline": mods["kernel.cross_attn.roofline"].read(rec),
                "launches_per_step": mods["decode.launches_per_step"].read(rec),
                "per_step": red["launches_per_step"],
                "ops_a_step_span": (red["spans"]["decode.step"]["ops"]
                                    / red["spans"]["decode.step"]["calls"]),
                "busy_ms": 1e3 * red["busy_s"], "window_ms": 1e3 * red["window_s"],
                "idle": T.idle_share(red), "graphs": red.get("graphs")}

    got = {"eager": read(eager), "graph": read(graphed), "logits_gap": graph_gap,
           "card": torch.cuda.get_device_name(card), "nodes": len(ctx.graphs.records["0"]["nodes"])}
    print("port_bench.graphs " + json.dumps(got))
    e, g = got["eager"], got["graph"]
    assert g["graphs"]["replays"] == n and g["graphs"]["unmatched"] == 0
    assert g["cross_kernels"] == e["cross_kernels"] > 0
    assert g["cross_calls"] == e["cross_calls"] == n * config.decoder_layers
    # the step span that opened before the stretch did is not in the trace:
    # each step span recorded holds the capture's nodes, eager or replayed
    assert g["ops_a_step_span"] == e["ops_a_step_span"] == got["nodes"]
    assert g["cross_device_ms_a_step"] == pytest.approx(e["cross_device_ms_a_step"], rel=0.10)
    assert g["cross_bound_ms_a_step"] == pytest.approx(e["cross_bound_ms_a_step"], rel=1e-9)
    assert g["roofline"] == pytest.approx(e["roofline"], rel=0.10)
    assert g["launches_per_step"] == 1.0 and set(g["per_step"]) == {1}
