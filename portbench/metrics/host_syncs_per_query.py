"""host_syncs_per_query: the statements in ``match_many`` that made the
host wait for the card (the program's ``host_syncs`` count: read-backs,
operations whose output size the host must learn, copies of host data to
the card), summed over the window's traces, over the queries they ran
(``queries``).  The traces come from the program's ring of 256
(``pb_counts``), which holds a whole window here: about 98 batches in
``pe50k.q8`` and 68 in ``pge20.q5`` at the ledger's rates.  Nothing where
no trace has the count."""
from pb_counts import ratio


def read(rec):
    return ratio(rec, "host_syncs", "queries")
