"""setup_s: from the process's start to the first timed batch — the
card's start, the kernels' libraries (built once a checkout), the graph
and the query pool, ``build()`` and the warm-up batches."""


def read(rec):
    return rec.setup_s
