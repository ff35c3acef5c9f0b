"""embed_plan_ms: the program's ``embed`` and ``plan`` spans, their sum's
mean over the window's batches (host clock)."""


def read(rec):
    got = [s.get("embed", 0.0) + s.get("plan", 0.0) for s in rec.stage_s if "embed" in s]
    return sum(got) / len(got) * 1e3 if got else None
