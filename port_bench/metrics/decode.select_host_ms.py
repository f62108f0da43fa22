"""Host milliseconds the decode loop spends choosing each token between
two ``decode_step`` calls in the label window (the rules, the argmax and
the bookkeeping of ``decode/greedy.py``), from the port's
``decode.select`` span: its seconds over its calls."""


def read(rec):
    s = rec["stats"].get("spans", {}).get("decode.select")
    return 1e3 * s["seconds"] / s["calls"] if s else None
