"""join_refine_ms: the program's ``join.refine`` spans, the exact
verification and the match tuples (each query's
``core/matcher.py::refine`` under the host join, each group's
``_refine_device_batch`` under the device join), their sum a batch, the
mean over the window's batches that have them (host clock).  Nothing
where no batch has the span."""


def read(rec):
    got = [s["join.refine"] for s in rec.stage_s if "join.refine" in s]
    return sum(got) / len(got) * 1e3 if got else None
