"""The benchmark of ``taiwan_whisper_tpu_torch`` on one H100.

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
window driver or per-layer metric sits in a file of its own, found by the
name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the model's published sizes, what was cut and
  assumed, and the deployment it stands for;
* ``traffic/<mix>.json``: the mix's parameters and the driver it runs;
* ``drivers/<driver>.py``: one window driver per entry point of the port;
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``roofline/``: peaks, and operations and bytes from shapes;
* ``reference/``: the plain PyTorch reference that decides ``correct``.

Nothing here imports JAX or the JAX package, and the reference imports
nothing of the port.
"""
