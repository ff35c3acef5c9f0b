"""join_ms: the program's ``assemble`` and ``join`` spans (candidate
assembly, join, refine), their sum's mean over the window's batches
(host clock)."""


def read(rec):
    got = [s.get("assemble", 0.0) + s.get("join", 0.0) for s in rec.stage_s if "join" in s]
    return sum(got) / len(got) * 1e3 if got else None
