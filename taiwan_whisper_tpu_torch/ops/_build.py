"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries land in
``build/torch_kernels/<hash of the sources>/`` beside the package, which
``.gitignore`` lists; ``build_all`` starts one ``nvcc`` per source, all
together. Every C entry point returns ``cudaGetLastError()`` after its
launch and ``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> Dict[str, str]:
    """kernel library name -> .cu path."""
    return {os.path.splitext(n)[0]: os.path.join(CSRC, n)
            for n in sorted(os.listdir(CSRC)) if n.endswith(".cu")}


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for n in sorted(os.listdir(CSRC)):
        if n.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, n), "rb") as f:
                h.update(n.encode() + f.read())
    return os.path.join(_ROOT, h.hexdigest()[:16])


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return found


def _start(name: str, src: str, out_dir: str):
    so = os.path.join(out_dir, f"lib{name}.so")
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return so, tmp, proc


def _finish(name, so, tmp, proc):
    log, _ = proc.communicate()
    with open(f"{so}.log", "wb") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log.decode(errors='replace')}")
    os.replace(tmp, so)


def build_all() -> float:
    """Compile every kernel source not yet built, one nvcc per source, all
    started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    started = [(n, *_start(n, s, out_dir)) for n, s in sources().items()
               if not os.path.exists(os.path.join(out_dir, f"lib{n}.so"))]
    errors = []
    for n, so, tmp, proc in started:
        try:
            _finish(n, so, tmp, proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for one library (with -Xptxas -v: registers, shared
    memory and spills of each kernel)."""
    with open(os.path.join(_build_dir(), f"lib{name}.so.log"), encoding="utf-8",
              errors="replace") as f:
        return f.read()


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives (or will)."""
    return os.path.join(_build_dir(), f"lib{name}.so")


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed, with
    ``argtypes`` set from ``signatures`` and every ``restype`` an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = library_path(name)
            if not os.path.exists(so):
                os.makedirs(os.path.dirname(so), exist_ok=True)
                _finish(name, *_start(name, sources()[name], os.path.dirname(so)))
            lib = ctypes.CDLL(so)
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "float8_e4m3fn": 3}


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"no CUDA kernel for dtype {t.dtype}")
    return DTYPE_CODES[name]


def require_cuda(*tensors):
    """Every tensor on one CUDA device, else raise: a wrapper given a
    non-CPU tensor launches its kernel or fails, never falls back."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device}")
