"""Model FLOPs of the window's samples (``roofline/whisper_flops.py``:
frozen encoder forward, the teacher decoder's forward when distilling, the
student decoder's forward and backward) over the window's wall times
989 TFLOP/s (bf16 dense), in percent."""

from port_bench.roofline import PEAK_FLOPS


def read(rec):
    if not rec.get("model_flops"):
        return None
    return 100.0 * rec["model_flops"] / (rec["window_s"] * PEAK_FLOPS["bf16"])
