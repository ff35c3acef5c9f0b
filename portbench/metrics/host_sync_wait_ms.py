"""host_sync_wait_ms: the host seconds spent in those statements (the
program's ``host_sync_s`` count: the wait for the card's queued work,
the copy, and the statement's own host work), summed over the window's
traces, over their number: ms a batch.  The traces come from the
program's ring of 256 (``pb_counts``), which holds a whole window here:
about 98 batches in ``pe50k.q8`` and 68 in ``pge20.q5`` at the ledger's
rates.  Nothing where no trace has the count."""
from pb_counts import ratio


def read(rec):
    got = ratio(rec, "host_sync_s", None)
    return got * 1e3 if got is not None else None
