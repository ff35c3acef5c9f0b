"""batch_p95_ms: the 95th percentile of the window's batch times
(``match_many`` on the host clock, each ending in a synchronize), over
every batch of the traced run's window."""
import statistics


def read(rec):
    xs = rec.batch_s
    if len(xs) < 2:
        return xs[0] * 1e3 if xs else None
    return statistics.quantiles(xs, n=20)[18] * 1e3
