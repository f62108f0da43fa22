"""The readings that the limits of ``correct`` are set from.

    python3 -m port_bench.readings --workload <cell> --seeds 1,2,3 --seconds 10 [--control]

runs the cell's driver once per seed in one process (set-up, a short window
at the cell's own load: ``--seconds`` of a timed window, ``--batches``
batches of a window of fixed work; then the comparison), and prints one
JSON line per seed with every compared number: the program's reading
and, with ``--control``, the control's (the reference in the precision
below the configuration's, in the program's place). ``--fault <name>``
plants one of ``faults.FAULTS`` in the program first. The benchmark's own
runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time


def readings(workload: str, seeds, seconds: float, control: bool, *, device=None,
             root: str = None, out=sys.stdout, fault: str = None, batches: int = 2):
    import torch

    from port_bench import harness, run

    root = root or run.ROOT
    run._cache_env(root)
    plan = harness.plan(root, workload)
    if device is None:
        device = torch.device("cuda:0")
        harness.steady_process()
    device = torch.device(device)
    driver = harness.load_driver(plan)
    rows = []
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="port_bench_", dir=os.environ.get("TMPDIR")) as wd:
            ctx = harness.Ctx(plan, seed=seed, seconds=seconds, trace=False, device=device,
                              workdir=wd, batches=batches)
            if fault:
                from port_bench import faults

                faults.FAULTS[fault](lambda obj, attr, new: ctx.patch(obj, attr, lambda _: new))
            t0 = time.time()
            try:
                res = driver.run(ctx, t_start=t0)
            finally:
                ctx.unpatch()
            gc.collect()
            checks = res["check"]()
            row = {"seed": seed, "attempted": res["attempted"], "e2e": res["e2e"],
                   "program": {c.name: c.value for c in checks},
                   "detail": {c.name: c.detail for c in checks if c.detail}}
            if control:
                checks = res["check"](control=True)
                row["control"] = {c.name: c.value for c in checks}
                row["control_detail"] = {c.name: c.detail for c in checks if c.detail}
            del res
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(prog="port_bench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--batches", type=int, default=2,
                   help="batches of a window of fixed work (the label cells)")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None, help="plant one of faults.FAULTS in the program")
    a = p.parse_args(argv)
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds, a.control,
             fault=a.fault, batches=a.batches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
