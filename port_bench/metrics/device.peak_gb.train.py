"""Peak device memory the allocator held during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in GB."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec.get("peak_bytes") else None
