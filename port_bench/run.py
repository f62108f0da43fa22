"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The run sets up (weights from the seed on the device, inputs from the
seed, one warm batch or step of the cell's shapes), measures for about
``--seconds`` seconds, then checks what the timed path produced against
the plain reference and prints the result as its last line. ``--trace 1``
reports the cell's per-layer metrics instead of its end-to-end ones.

It exits with a code other than 0 and prints no result when CUDA is absent
or has fewer cards than the cell asks for, and when JAX or the JAX package
was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_START = time.time()  # before the heavy imports: they are set-up too

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_env(root: str):
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port builds its CUDA libraries into ``build/torch_kernels/`` itself)."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(prog="port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, device=None, root: str = ROOT, t_start: float = None) -> int:
    """``device`` and ``root`` are for the CPU tests: the command itself
    runs on ``cuda:0`` from the checkout it lies in."""
    args = parse(argv)
    t_start = T_START if t_start is None else t_start
    _cache_env(root)

    import torch

    from . import harness

    plan = harness.plan(root, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("port_bench: CUDA is not available", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < plan.chips:
            print(f"port_bench: {plan.chips} cards asked for, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
        harness.steady_process()
    device = torch.device(device)

    driver = harness.load_driver(plan)
    metric_mods = harness.load_metrics(plan) if args.trace else {}
    tmp_root = os.environ.get("TMPDIR") or None
    with tempfile.TemporaryDirectory(prefix="port_bench_", dir=tmp_root) as wd:
        ctx = harness.Ctx(plan, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          device=device, workdir=wd)
        try:
            if args.trace:
                from .trace import watch_graphs

                watch_graphs(ctx)
            for mod in metric_mods.values():
                if hasattr(mod, "install"):
                    mod.install(ctx)
            out = driver.run(ctx, t_start=t_start)
            peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        finally:
            ctx.unpatch()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = out["check"]()
    banned = harness.banned_loaded()
    if banned:
        print(f"port_bench: loaded in this process: {', '.join(banned)}", file=sys.stderr)
        return 3

    correct = all(c.ok for c in checks)
    failed = sum(c.items for c in checks) if not correct else 0
    if args.trace:
        record = dict(out["record"], trace=ctx.traces())
        metrics = {}
        for m in plan.per_layer:
            v = metric_mods[m["name"]].read(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        # a reading that only the card gives (device memory) is absent on the CPU
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in plan.end_to_end if out["e2e"].get(m["name"]) is not None}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": plan.chips, "memory_peak_bytes": int(peak)}
    red = ctx.traces().get(plan.traffic.get("trace", {}).get("main", ""))
    if args.trace and red is not None:
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
    from .trace import breakdown

    line = harness.result_line(correct=correct, attempted=out["attempted"], failed=failed,
                               metrics=metrics, device=dev, checks=checks,
                               breakdown=breakdown(red) if args.trace else None)
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
