"""Deterministic, resumable data pipelines (NumPy only: the JAX package's
``data/pipeline.py``, copied, so each (seed, step) gives the same batch in
both packages).

Every batch is a pure function of ``(seed, step)`` — resuming from a
checkpoint needs only the step counter (no iterator state to persist),
and every data-parallel worker derives its own shard of the batch from
the same function (loader-side sharding).  A background prefetch thread
overlaps host batch synthesis with device compute.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["LMSyntheticData", "RecsysSyntheticData", "GraphTaskData", "Prefetcher"]


class LMSyntheticData:
    """Zipf-distributed token stream with local structure (bigram chains) —
    enough signal that a small LM's loss visibly drops in a few hundred steps."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        # fixed random bigram successor table: x_{t+1} = succ[x_t] w.p. 0.7
        self._succ = rng.integers(0, vocab, size=vocab)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** -1.1
        self._p = p / p.sum()

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(self.vocab, size=self.batch, p=self._p)
        follow = rng.random((self.batch, self.seq_len)) < 0.7
        fresh = rng.choice(self.vocab, size=(self.batch, self.seq_len), p=self._p)
        for t in range(1, self.seq_len + 1):
            toks[:, t] = np.where(follow[:, t - 1], self._succ[toks[:, t - 1]], fresh[:, t - 1])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class RecsysSyntheticData:
    """Click model: label depends on a few feature crossings (so DCN can learn)."""

    def __init__(self, cfg, batch: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        dense = rng.normal(size=(self.batch, self.cfg.n_dense)).astype(np.float32)
        sparse = rng.integers(0, self.cfg.vocab_per_field, (self.batch, self.cfg.n_sparse)).astype(np.int32)
        z = (
            0.8 * dense[:, 0] * dense[:, 1]
            + 0.5 * ((sparse[:, 0] % 7) == (sparse[:, 1] % 7)).astype(np.float32)
            - 0.3 * dense[:, 2]
        )
        label = (z + rng.normal(scale=0.3, size=self.batch) > 0).astype(np.float32)
        return {"dense": dense, "sparse": sparse, "label": label}


class GraphTaskData:
    """Node-classification batches for a fixed graph (labels = noisy function
    of neighborhood label histogram so message passing helps)."""

    def __init__(self, graph, d_feat: int, n_classes: int, seed: int = 0):
        self.g = graph
        rng = np.random.default_rng(seed)
        self.feat = rng.normal(size=(graph.n_vertices, d_feat)).astype(np.float32)
        # ground truth: class = argmax over neighborhood label votes
        base = rng.integers(0, n_classes, graph.n_vertices)
        votes = np.zeros((graph.n_vertices, n_classes))
        e = graph.edge_array()
        for u, v in e:
            votes[u, base[v]] += 1
            votes[v, base[u]] += 1
        votes[np.arange(graph.n_vertices), base] += 1.5
        self.labels = votes.argmax(1).astype(np.int32)
        self.edge_index = np.concatenate([e, e[:, ::-1]], axis=0).astype(np.int32)

    def full_batch(self) -> dict:
        return {"node_feat": self.feat, "edge_index": self.edge_index, "labels": self.labels}


class Prefetcher:
    """Overlap host batch synthesis with device compute (depth-bounded)."""

    def __init__(self, fn, start_step: int = 0, depth: int = 2):
        self.fn = fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.fn(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
