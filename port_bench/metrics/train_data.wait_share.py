"""Share of the train window's wall that the step loop spent waiting for
the next batch from the data layer (the benchmark's span around each
``next()`` of ``utils/prefetch.py::prefetch``), in percent."""


def read(rec):
    return 100.0 * rec["data_wait_s"] / rec["window_s"] if rec.get("window_s") else None
