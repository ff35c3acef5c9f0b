"""leaf_pairs_per_query: the program's ``gnnpe_probe_pairs_total``
counter (kind ``leaf_pairs``: the (query path, data path) pairs the probe
hands to the leaf verdict) over the window, per query answered."""


def read(rec):
    if rec.leaf_pairs is None or not rec.queries:
        return None
    return rec.leaf_pairs / rec.queries
