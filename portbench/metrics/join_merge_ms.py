"""join_merge_ms: the program's ``join.merge`` spans, the multi-way join
steps (each query's ``core/matcher.py::join_candidates`` under the host
join; each group's ``_join_candidates_device_batch`` and the grouping by
canonical key under the device join), their sum a batch, the mean over
the window's batches that have them (host clock).  Nothing where no batch
has the span."""


def read(rec):
    got = [s["join.merge"] for s in rec.stage_s if "join.merge" in s]
    return sum(got) / len(got) * 1e3 if got else None
