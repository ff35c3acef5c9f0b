"""k2_roofline: K2's share of its roofline over the traced slice — the
least time of its calls' work (``rooflines/k2.py``, at the card's
published peaks) against its kernels' device time under
``torch.profiler``.  Nothing where the two passes saw a different number
of calls or no kernel ran."""

ROOFLINE = "k2"


def read(rec):
    r = (rec.profile or {}).get("rooflines", {}).get(ROOFLINE)
    if not r or r["kernel_s"] <= 0 or r["calls"] != r["launches"]:
        return None
    return 100.0 * r["bound_s"] / r["kernel_s"]
