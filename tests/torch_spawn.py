"""Launch a script as N ranks of a ``torch.distributed`` run on the CPU, as
``torchrun`` would (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), for the port's multi-process tests.

A test module takes it with ``from torch_spawn import launch``. Each rank
blocks ``jax`` and the JAX package before anything imports them, runs
torch on one intra-op thread, and has its own timeout; a failed or
timed-out rank fails the test with every rank's output.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = (
    "import sys\n"
    "for _m in ('jax', 'jaxlib', 'taiwan_whisper_tpu'):\n"
    "    sys.modules[_m] = None\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(code: str, world: int, args=()) -> list:
    """Start ``code`` (after the prelude) as ``world`` ranks with ``args``
    on its command line; ``finish`` waits for them."""
    port = str(free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", PRELUDE + code, *map(str, args)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      cwd=REPO, env=env))
    return procs


def finish(procs: list, timeout: float = 120.0) -> list:
    """Each rank's output, once every rank has exited 0 within ``timeout``
    seconds; a rank still running then is killed, and the test fails."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join(f"--- rank {r} (rc {procs[r].returncode}):\n{outs[r]}"
                                 for r in failed)
    return outs


def launch(code: str, world: int, args=(), timeout: float = 120.0) -> list:
    """``start`` then ``finish``."""
    return finish(start(code, world, args), timeout)
