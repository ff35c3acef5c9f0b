"""probe_join_ms: the program's ``probe``, ``assemble`` and ``join``
spans, their sum's mean over the window's batches (host clock).  Under
the hand-off to the device join the probe's queued device work can end
inside the join's span, so only the sum is sound."""


def read(rec):
    got = [s.get("probe", 0.0) + s.get("assemble", 0.0) + s.get("join", 0.0)
           for s in rec.stage_s if "join" in s]
    return sum(got) / len(got) * 1e3 if got else None
