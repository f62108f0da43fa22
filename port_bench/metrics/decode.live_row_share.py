"""Share of the decode loop's row-steps in the label window that served a
real row still decoding: the port's ``label.live_row_steps`` counter
(each real row's ``min(length + 1, steps)``) over ``decode.row_steps``
(each batch's steps times its rows, padding included), in percent."""


def read(rec):
    c = rec["stats"].get("counts", {})
    if not c.get("decode.row_steps") or "label.live_row_steps" not in c:
        return None
    return 100.0 * c["label.live_row_steps"] / c["decode.row_steps"]
