"""Host milliseconds of one ``models/whisper.py::decode_step`` call in
the label window, from the port's ``decode.step`` span: its seconds over
its calls. A greedy step is host-bound, so this is the step's wall less
what the decode loop does around it."""


def read(rec):
    s = rec["stats"].get("spans", {}).get("decode.step")
    return 1e3 * s["seconds"] / s["calls"] if s else None
