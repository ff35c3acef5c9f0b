"""join_group_width: the queries a device-join group holds, the
program's ``queries`` over its ``join_groups`` (the groups of one WL key
and canonical plan that ``core/matcher.py::match_from_candidates_many``
runs as one chain of steps), summed over the window's traces.  The
traces come from the program's ring of 256 (``pb_counts``), which holds a
whole window here: about 68 batches in ``pge20.q5`` at the ledger's rate.
Nothing where no trace has the count (the host join, or a program
without it)."""
from pb_counts import ratio


def read(rec):
    got = ratio(rec, "join_groups", "queries")
    return 1.0 / got if got else None
