"""Command line of the PyTorch port.

    python -m taiwan_whisper_tpu_torch.cli label --manifest ... --model ... \\
        --output_dir ... [--device cuda|cpu]

``label`` takes the JAX CLI's flags (taiwan_whisper_tpu/cli.py) plus
``--device``; options this slice does not run yet (spectral/energy VAD,
beam search, speculative decoding, the resident transport) raise
NotImplementedError. The other subcommands wait for later slices.
"""

from __future__ import annotations

import argparse
import json


def _quant_arg(v: str):
    """--quantize_kv value: off/0/false | 8/int8/true | 4/int4 | fp8."""
    s = str(v).strip().lower()
    if s in ("", "0", "off", "false", "none"):
        return 0
    if s in ("8", "int8", "true", "1"):
        return 8
    if s in ("4", "int4"):
        return 4
    if s in ("fp8", "e4m3", "float8"):
        return "fp8"
    raise argparse.ArgumentTypeError(f"--quantize_kv must be off/8/4/fp8, got {v!r}")


def cmd_label(args):
    from .pipeline.label import LabelConfig, run_labelling

    unported = [name for name, on in (
        ("--no_pooled", args.no_pooled),
        ("--wire_mode resident", args.wire_mode == "resident"),
        ("--pack_regions", args.pack_regions),
        ("--group_segs", args.group_segs is not None),
        ("--assistant", args.assistant is not None),
        ("--validation_manifest", args.validation_manifest is not None),
        ("--distributed", args.distributed),
    ) if on]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)} wait(s) for a later slice of the port (ROADMAP)")
    stats = run_labelling(
        args.manifest, args.model, args.output_dir,
        LabelConfig(
            language=args.language, strategy=args.strategy,
            batch_size=args.batch_size,
            energy_vad_threshold=args.energy_vad_threshold,
            vad_regions=args.vad_mode != "off",
            vad_mode=args.vad_mode,
            quantize_kv=args.quantize_kv,
            num_beams=args.num_beams,
            max_decode_tokens=args.max_decode_tokens,
        ),
        tokenizer_dir=args.tokenizer_dir,
        device=args.device,
    )
    print(json.dumps(stats))
    return stats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="taiwan_whisper_tpu_torch",
                                 fromfile_prefix_chars="@")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("label", help="stage 1: pseudo-label long audio")
    p.add_argument("--manifest", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--language", default="zh")
    p.add_argument("--strategy", default="chunked", choices=["chunked", "sequential"])
    p.add_argument("--batch_size", type=int, default=96)
    p.add_argument("--energy_vad_threshold", type=float, default=0.0)
    p.add_argument("--vad_mode", default="spectral",
                   choices=["spectral", "spectral-device", "spectral-host",
                            "energy", "off"],
                   help="region-gated decode; this slice runs 'off' (whole file)")
    p.add_argument("--quantize_kv", type=_quant_arg, nargs="?", const=8,
                   default=0, metavar="MODE",
                   help="cross-KV quantization: bare flag or 8 -> int8, fp8 -> "
                        "e4m3, off -> disabled (4 waits for a later slice)")
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--no_pooled", action="store_true")
    p.add_argument("--wire_mode", default="auto", choices=["auto", "resident", "chunks"],
                   help="this slice runs the staged-chunk transport")
    p.add_argument("--group_segs", type=int, default=None)
    p.add_argument("--pack_regions", action="store_true")
    p.add_argument("--max_decode_tokens", type=int, default=None,
                   help="cap sampled tokens per 30 s chunk (None = model max 448)")
    p.add_argument("--assistant", default=None)
    p.add_argument("--num_draft_tokens", type=int, default=5)
    p.add_argument("--validation_manifest", default=None)
    p.add_argument("--tokenizer_dir", default=None,
                   help="dir with vocab.json/merges.txt (optional)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda; 'cpu' runs the "
                        "plain PyTorch path)")
    p.set_defaults(fn=cmd_label)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
