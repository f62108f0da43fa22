"""Model FLOPs of the window's real chunks (``roofline/whisper_flops.py``:
encoder, cross K/V, prefill, and one decode step per token each row
served, from the lengths ``label_files`` returned; padding rows not
counted) over the window's wall times 989 TFLOP/s (bf16 dense), in
percent. The count follows the work, not the port's calls: fusing or
replaying steps leaves it as it is."""

from port_bench.roofline import PEAK_FLOPS


def read(rec):
    if not rec.get("model_flops"):
        return None
    return 100.0 * rec["model_flops"] / (rec["window_s"] * PEAK_FLOPS["bf16"])
