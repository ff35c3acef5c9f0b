"""Batched LM decode service with slot-based continuous batching, as the
JAX package's ``serve/engine.py`` runs it.

A fixed pool of ``max_batch`` slots over one pre-allocated KV cache; a
finished request frees its slot for the queue on the next tick.  Each
tick is one ``decode_step`` for every slot: a slot still holding prompt
tokens is teacher-forced one token a tick, the others feed back their
last pick, the argmax taken on the host.  The reference's semantics are
kept as they are: one ``cur_len`` is shared by all slots and never
resets, so a reused slot attends to its previous occupant's cache rows,
and the engine stops at ``max_len − 1``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import default_device
from ..models import TransformerConfig, decode_step, init_cache

__all__ = ["ServeConfig", "DecodeEngine"]


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    eos_token: int = 1


@dataclasses.dataclass
class _Slot:
    request_id: int
    tokens: list
    prompt_left: list  # prompt tokens not yet consumed
    max_new: int


class DecodeEngine:
    """``params`` in the compute dtype (``models.cast_params`` makes them
    so; the reference casts each weight at each use); the cache lives on
    ``device`` (the card unless told otherwise), where the params must lie
    too."""

    def __init__(self, params, cfg: TransformerConfig, scfg: ServeConfig, device=None):
        self.device = default_device(device)
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.cache = init_cache(cfg, scfg.max_batch, scfg.max_len, device=self.device)
        self.cur_len = 0
        self.slots: list = [None] * scfg.max_batch
        self.queue: list = []
        self.finished: dict = {}
        self._next_id = 0

    def submit(self, prompt: list, max_new: int = 32) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, list(prompt), max_new))
        return rid

    def _admit(self) -> None:
        for i in range(self.scfg.max_batch):
            if self.slots[i] is None and self.queue:
                rid, prompt, max_new = self.queue.pop(0)
                self.slots[i] = _Slot(rid, [], prompt, max_new)

    def step(self) -> int:
        """One decode tick for all active slots; returns #active."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active or self.cur_len >= self.scfg.max_len - 1:
            return 0
        toks = np.zeros((self.scfg.max_batch,), np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if s.prompt_left:  # teacher-force the prompt first
                toks[i] = s.prompt_left.pop(0)
            else:
                toks[i] = s.tokens[-1] if s.tokens else 0
        logits, self.cache = decode_step(
            self.params, self.cache, torch.from_numpy(toks).to(self.device), self.cur_len,
            self.cfg,
        )
        self.cur_len += 1
        nxt = logits.argmax(-1).cpu().numpy()
        for i, s in enumerate(self.slots):
            if s is None or s.prompt_left:
                continue
            tok = int(nxt[i])
            s.tokens.append(tok)
            if tok == self.scfg.eos_token or len(s.tokens) >= s.max_new:
                self.finished[s.request_id] = s.tokens
                self.slots[i] = None  # free the slot (continuous batching)
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> dict:
        for _ in range(max_ticks):
            if self.step() == 0 and not self.queue:
                break
        return self.finished
