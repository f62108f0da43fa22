"""Share of the decoded batch slots that were padding (``pad_slots`` over
batches times the batch size), in percent."""


def read(rec):
    st = rec["stats"]
    slots = st["batches"] * rec["batch_size"]
    return 100.0 * st["pad_slots"] / slots if slots else None
