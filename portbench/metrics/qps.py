"""qps: the queries answered in the window over the window's seconds
(host clock; every batch ends in a synchronize)."""


def read(rec):
    return rec.queries / rec.window_s if rec.window_s > 0 else None
