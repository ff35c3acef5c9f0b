"""device_idle_pct: the share of the traced slice in which nothing runs
on the card (the union of the device's operations under
``torch.profiler``, against the slice's length)."""


def read(rec):
    p = rec.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
