"""probe_ms: the program's ``probe`` span, its mean over the window's
batches (host clock).  With the host join the probe ends in the
read-back of its candidates, so its span holds its device work."""


def read(rec):
    got = [s["probe"] for s in rec.stage_s if "probe" in s]
    return sum(got) / len(got) * 1e3 if got else None
