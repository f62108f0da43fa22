"""The cross kernel of this checkout against an older one's, bitwise, on the card.

    python -m taiwan_whisper_tpu_torch.tools.ab_cross_kernel --parent DIR

``DIR`` is a checkout (``git archive`` of an earlier commit) whose
``taiwan_whisper_tpu_torch/csrc/decode_attention.cu`` exports
``twt_cross_attention`` with this checkout's C signature. Both sources are
built with the package's nvcc flags; the wrapper ``cross_attention`` then
runs on the same inputs through each library in turn. At batch 8 and 32
and on bf16, int8 and fp8 storage (large-v2's 20 heads over 1500 frames),
the 1- and 3-row calls the greedy path makes must give bit-equal outputs
from both kernels and equal the same rows of one 15-row call. Prints one
JSON object as its last line and exits 1 if any case differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from ..models.config import resolve_device
from ..ops import _build
from ..ops import decode_attention as DA

HEADS, FRAMES = 20, 1500
# (rows, first row) of the calls the greedy path makes: the step and the sot
# prefill, at the first tile and inside the second
CALLS = ((1, 0), (3, 0), (3, 8))


def _parent_kernel(parent: str, out_dir: str):
    src = os.path.join(parent, "taiwan_whisper_tpu_torch", "csrc", "decode_attention.cu")
    so = os.path.join(out_dir, "libdecode_attention_parent.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(so).twt_cross_attention
    fn.argtypes = DA._SIG["twt_cross_attention"]
    fn.restype = ctypes.c_int
    return fn


def _through(fn, q, k, v):
    """``cross_attention`` with its C entry swapped for ``fn``."""
    own = DA._kernel("twt_cross_attention")
    DA._bound["twt_cross_attention"] = fn
    try:
        return DA.cross_attention(q, k, v)
    finally:
        DA._bound["twt_cross_attention"] = own


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="checkout holding the older kernel")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    _build.build_all()
    out_dir = os.path.dirname(_build.library_path("decode_attention"))
    parent = _parent_kernel(args.parent, out_dir)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    bf16, d = torch.bfloat16, DA.HEAD_DIM
    same = {}
    for b in (8, 32):
        base = torch.randn((b, HEADS, d, FRAMES), generator=g, device=dev)
        int8 = torch.randint(-127, 128, base.shape, generator=g, device=dev, dtype=torch.int8)
        stores = {"bf16": (base.to(bf16), (base * 0.5).to(bf16), 0.125),
                  "int8": (int8, int8, 0.002),
                  "fp8": ((base * 50).to(torch.float8_e4m3fn),
                          (base * 25).to(torch.float8_e4m3fn), 0.0025)}
        for store, (k, v, q_scale) in stores.items():
            k, v = DA.time_minor_copy(k), DA.time_minor_copy(v)
            q15 = (torch.randn((b, 15, HEADS, d), generator=g, device=dev) * q_scale).to(bf16)
            out15 = DA.cross_attention(q15, k, v)
            for rows, first in CALLS:
                q = q15[:, first: first + rows].contiguous()
                new = DA.cross_attention(q, k, v)
                key = f"B={b} {store} rows={rows} from {first}"
                same[f"{key}: parent"] = torch.equal(new, _through(parent, q, k, v))
                same[f"{key}: rows of 15"] = torch.equal(new, out15[:, first: first + rows])
    ok = all(same.values())
    print(json.dumps({"ok": ok, "bitwise": same}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
