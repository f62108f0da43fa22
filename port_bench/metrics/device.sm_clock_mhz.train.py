"""Mean SM clock of the card over the train window, in MHz: NVML's
readings every ``card_sample_ms`` (``port_bench/card.py``) between the
window's opening and its closing synchronisation. It tells a slow card
(a power or thermal cap) from a slow program. None where no reading lies
in the window (no NVML, as on a CPU-only machine)."""


def read(rec):
    return (rec.get("card") or {}).get("sm_clock_mhz")
