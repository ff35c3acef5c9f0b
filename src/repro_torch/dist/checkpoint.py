"""Atomic, async, *verified* checkpointing, without JAX.

The JAX package's ``dist/checkpoint.py`` layout and commit order, so a
step written by either package restores in the other:

Layout: one ``step_<n>.npz`` plus a ``step_<n>.manifest.json`` sidecar per
checkpoint under the manager's dir.  A state is a tree of dicts, lists and
tuples (``None`` holds no leaf) whose leaves are tensors, arrays or
scalars; its leaves are stored in key order under the JAX package's key
strings (``['a']['b']``, ``[0]``; dict keys sorted).
Atomicity: arrays are staged to ``*.tmp`` and ``os.replace``d into place;
the manifest is written (same tmp/replace discipline) only *after* the npz
is durable, then the directory is fsync'd: manifest presence is the commit
point, so a crash mid-write never leaves a checkpoint that
``latest_step()`` would pick up.
Verification: the manifest (``format`` 1) records the npz byte size, a
whole-file sha256 and a per-leaf sha256/dtype/shape digest.  ``restore()``
re-checks all of them and raises :class:`CorruptCheckpointError` on any
mismatch; ``restore(step=None)`` / ``latest_step()`` skip invalid steps
(torn, bit-flipped or manifest-less) and fall back to the newest valid one.
Placement: tensors go to the host before they are written; ``restore(...,
device=...)`` puts every restored leaf on ``device`` (the JAX package's
``shardings=``): the stored form is plain host arrays, whatever device
wrote them.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
from pathlib import Path

import numpy as np
import torch

from ..device import default_device

__all__ = ["CheckpointManager", "CorruptCheckpointError"]

_PREFIX = "step_"
_MANIFEST_FORMAT = 1
_DICT_KEY = re.compile(r"^\['([^']*)'\]$")


class CorruptCheckpointError(RuntimeError):
    """A checkpoint step failed manifest/digest verification."""


def _flatten(tree, prefix: str = "") -> tuple[list, list]:
    """(keys, leaves) in the JAX package's order and key strings."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [prefix], [tree]
    keys, leaves = [], []
    for k, v in items:
        ks, ls = _flatten(v, prefix + k)
        keys += ks
        leaves += ls
    return keys, leaves


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf: a later in-place write to the leaf (or a CPU
    tensor's storage) leaves the snapshot as it was."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _leaf_digest(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # fault-injection hook: runs between the npz becoming durable and the
        # manifest commit (the window a crash leaves an uncommitted, and so
        # skipped, step)
        self._pre_commit = None

    # ------------------------------------------------------------ paths ---
    def _path(self, step: int) -> Path:
        return self.dir / f"{_PREFIX}{step}.npz"

    def _manifest_path(self, step: int) -> Path:
        return self.dir / f"{_PREFIX}{step}.manifest.json"

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.dir.glob(f"{_PREFIX}*.npz"):
            try:
                steps.append(int(p.stem[len(_PREFIX):]))
            except ValueError:
                continue
        return sorted(steps)

    def valid_steps(self) -> list[int]:
        """Steps that pass manifest verification, ascending."""
        out = []
        for s in self.all_steps():
            try:
                self.verify_step(s)
            except CorruptCheckpointError:
                continue
            out.append(s)
        return out

    def latest_step(self) -> int | None:
        steps = self.valid_steps()
        return steps[-1] if steps else None

    # ----------------------------------------------------------- verify ---
    def verify_step(self, step: int) -> dict:
        """Check manifest presence and the whole-file digest; return the
        manifest.  Raises :class:`CorruptCheckpointError` on a missing step,
        a missing or unreadable manifest, a size or a sha256 mismatch."""
        npz = self._path(step)
        mpath = self._manifest_path(step)
        if not npz.exists():
            raise CorruptCheckpointError(f"step {step}: missing {npz.name}")
        if not mpath.exists():
            raise CorruptCheckpointError(f"step {step}: uncommitted (no manifest)")
        try:
            manifest = json.loads(mpath.read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise CorruptCheckpointError(f"step {step}: unreadable manifest: {e}") from e
        data = npz.read_bytes()
        if len(data) != manifest.get("size"):
            raise CorruptCheckpointError(
                f"step {step}: size {len(data)} != manifest {manifest.get('size')}"
            )
        if hashlib.sha256(data).hexdigest() != manifest.get("sha256"):
            raise CorruptCheckpointError(f"step {step}: file sha256 mismatch")
        return manifest

    # ------------------------------------------------------------- save ---
    def save(self, step: int, state) -> None:
        keys, leaves = _flatten(state)
        self._write(step, keys, [_to_host(x) for x in leaves])

    def save_async(self, step: int, state) -> None:
        """Snapshot to the host, then write on a background thread."""
        keys, leaves = _flatten(state)
        host = [_to_host(x) for x in leaves]
        self.wait()
        self._thread = threading.Thread(target=self._write, args=(step, keys, host), daemon=True)
        self._thread.start()

    def _write(self, step: int, keys: list, host: list) -> None:
        arrays = {f"arr_{i}": x for i, x in enumerate(host)}
        arrays["__keys__"] = np.asarray(json.dumps(keys))
        final = self._path(step)
        tmp = final.with_suffix(final.suffix + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        data = tmp.read_bytes()
        os.replace(tmp, final)
        if self._pre_commit is not None:
            self._pre_commit()
        manifest = {
            "format": _MANIFEST_FORMAT,
            "step": int(step),
            "npz": final.name,
            "size": len(data),
            "sha256": hashlib.sha256(data).hexdigest(),
            "leaves": {
                k: {"sha256": _leaf_digest(x), "dtype": str(x.dtype), "shape": list(x.shape)}
                for k, x in zip(keys, host)
            },
        }
        mfinal = self._manifest_path(step)
        mtmp = mfinal.with_suffix(mfinal.suffix + ".tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, mfinal)
        # the dir fsync pins both renames: after it the step survives a power
        # cut; before it, verify_step() treats the step as absent
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._gc()

    def wait(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            for p in (self._path(s), self._manifest_path(s)):
                try:
                    p.unlink()
                except FileNotFoundError:
                    pass

    # ------------------------------------------------------------- load ---
    def _load_verified(self, step: int) -> tuple[list, list]:
        """(keys, arrays) of a step, after the whole-file and per-leaf checks."""
        manifest = self.verify_step(step)
        with np.load(self._path(step)) as z:
            saved_keys = json.loads(str(z["__keys__"]))
            saved = [z[f"arr_{i}"] for i in range(len(saved_keys))]
        want = manifest.get("leaves", {})
        if sorted(want) != sorted(saved_keys):
            raise CorruptCheckpointError(f"step {step}: leaf keys differ from manifest")
        for k, arr in zip(saved_keys, saved):
            rec = want[k]
            if str(arr.dtype) != rec["dtype"] or list(arr.shape) != rec["shape"]:
                raise CorruptCheckpointError(f"step {step}: leaf {k} dtype/shape mismatch")
            if _leaf_digest(arr) != rec["sha256"]:
                raise CorruptCheckpointError(f"step {step}: leaf {k} digest mismatch")
        return saved_keys, saved

    def _resolve_step(self, step: int | None) -> tuple[int, list, list]:
        if step is not None:
            keys, saved = self._load_verified(int(step))
            return int(step), keys, saved
        for s in reversed(self.all_steps()):
            try:
                keys, saved = self._load_verified(s)
                return s, keys, saved
            except CorruptCheckpointError:
                continue
        raise FileNotFoundError(f"no valid checkpoints under {self.dir}")

    def restore_arrays(self, step: int | None = None) -> tuple[dict, int]:
        """Verified load → ``({key: np.ndarray}, step)``, no template needed.
        Single-level dict keys (``['name']``) come back as plain names, so a
        flat-dict ``save()`` round-trips."""
        self.wait()
        step, keys, saved = self._resolve_step(step)
        out = {}
        for k, arr in zip(keys, saved):
            m = _DICT_KEY.match(k)
            out[m.group(1) if m else k] = arr
        return out, step

    def restore(self, template, step: int | None = None, device=None):
        """Load a checkpoint into ``template``'s tree structure → ``(tree,
        step)``, every leaf a tensor on ``device`` (the card unless the
        caller names another) in its template leaf's dtype.  An explicit
        ``step`` that fails verification raises
        :class:`CorruptCheckpointError`; ``step=None`` skips invalid steps."""
        self.wait()
        dev = default_device(device)
        step, saved_keys, saved = self._resolve_step(step)
        keys, leaves = _flatten(template)
        if keys != saved_keys:
            raise ValueError(f"checkpoint tree mismatch: saved {saved_keys} vs template {keys}")
        out = []
        for key, tmpl, arr in zip(keys, leaves, saved):
            t = tmpl if isinstance(tmpl, torch.Tensor) else torch.as_tensor(np.asarray(tmpl))
            if tuple(t.shape) != tuple(arr.shape):
                raise ValueError(
                    f"shape mismatch at {key}: checkpoint {arr.shape} vs template {tuple(t.shape)}"
                )
            out.append(torch.as_tensor(arr).to(device=dev, dtype=t.dtype))
        return _unflatten(template, iter(out)), int(step)
