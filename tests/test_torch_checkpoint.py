"""The port's checkpoints (``dist/checkpoint.py``) and record framing
(``durability/wal.py``), held against the JAX package on the CPU.

A step the reference writes restores in the port, tensors on the device
asked for, and a step the port writes restores in the reference; the leaf
keys are the reference's key strings; torn, bit-flipped and manifest-less
steps are skipped by ``latest_step`` and raise where named; ``keep`` prunes
old steps, ``save_async`` commits on a thread, and the pre-commit window
leaves no step behind.  Frames are byte-equal to the reference's and
rejected alike."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.durability import wal as RW  # noqa: E402
from repro_torch.dist.checkpoint import (  # noqa: E402
    CheckpointManager,
    CorruptCheckpointError,
    _flatten,
)
from repro_torch.durability import wal as PW  # noqa: E402


def ref_state(step: int) -> dict:
    return {
        "params": {"w": jnp.arange(12.0).reshape(3, 4) * step, "b": jnp.ones(4, jnp.int32)},
        "layers": [np.arange(5, dtype=np.int64) + step, (jnp.zeros((2, 2)) + step, None)],
        "step": np.asarray(step),
    }


def port_state(step: int) -> dict:
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4) * step,
                   "b": torch.ones(4, dtype=torch.int32)},
        "layers": [torch.arange(5) + step, (torch.zeros((2, 2)) + step, None)],
        "step": np.asarray(step),
    }


def test_keys_are_the_reference_key_strings():
    """``_flatten``'s keys and leaf order equal ``jax.tree_util``'s keystr
    paths: dict keys sorted, list and tuple positions, ``None`` no leaf."""
    for tree in ({"b": [1, (2, None, {"z": 3})], "a": {"y": 4, "x": 5}}, {1: [7], 0: 8}, [9]):
        leaves_with_path, _ = jax.tree_util.tree_flatten_with_path(tree)
        keys, leaves = _flatten(tree)
        assert keys == [jax.tree_util.keystr(p) for p, _ in leaves_with_path]
        assert leaves == [leaf for _, leaf in leaves_with_path]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_steps_cross_between_packages(tmp_path, writer):
    """Both packages write a nested state at steps 1 and 2 through the same
    directory layout; each restores the other's (arrays, manifests and the
    template form), the port's tensors on the CPU in the template's
    dtypes."""
    mgr = (RefManager if writer == "reference" else CheckpointManager)(tmp_path)
    for s in (1, 2):
        mgr.save(s, ref_state(s) if writer == "reference" else port_state(s))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_1.manifest.json", "step_1.npz", "step_2.manifest.json", "step_2.npz"]
    manifest = json.loads((tmp_path / "step_2.manifest.json").read_text())
    assert manifest["format"] == 1 and manifest["step"] == 2
    port, ref = CheckpointManager(tmp_path), RefManager(tmp_path)
    assert port.valid_steps() == ref.valid_steps() == [1, 2]
    got, step = port.restore_arrays()
    want, ref_step = ref.restore_arrays()
    assert step == ref_step == 2 and sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert sorted(port.verify_step(2)["leaves"]) == sorted(_flatten(port_state(2))[0])
    restored, step = port.restore(port_state(0), step=1, device="cpu")
    assert step == 1 and restored["layers"][1][1] is None
    assert restored["params"]["b"].dtype == torch.int32
    assert isinstance(restored["layers"], list) and isinstance(restored["layers"][1], tuple)
    np.testing.assert_array_equal(restored["params"]["w"].numpy(), np.arange(12.0).reshape(3, 4))
    assert torch.equal(restored["layers"][1][0], torch.ones(2, 2))
    ref_restored, _ = ref.restore(ref_state(0), step=1)
    np.testing.assert_array_equal(np.asarray(ref_restored["layers"][0]),
                                  restored["layers"][0].numpy())
    with pytest.raises(ValueError, match="tree mismatch"):
        port.restore({"w": torch.zeros(1)}, device="cpu")
    bad = port_state(0)
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        port.restore(bad, device="cpu")


def damage(mgr, kind: str, step: int) -> None:
    if kind == "torn":
        p = mgr._path(step)
        with open(p, "r+b") as f:
            f.truncate(p.stat().st_size // 2)
    elif kind == "flipped":
        p = mgr._path(step)
        data = bytearray(p.read_bytes())
        data[-20] ^= 0xFF
        p.write_bytes(bytes(data))
    else:
        os.unlink(mgr._manifest_path(step))  # crashed before the manifest commit


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("kind", ["torn", "flipped", "no_manifest"])
def test_damaged_steps_are_skipped_or_raise(tmp_path, kind, writer):
    """A torn, bit-flipped or manifest-less newest step: ``latest_step`` and
    ``restore(step=None)`` fall back to the older valid one, as the
    reference's do; naming the step raises ``CorruptCheckpointError``."""
    mgr = (RefManager if writer == "reference" else CheckpointManager)(tmp_path)
    for s in (1, 2):
        mgr.save(s, {"w": np.arange(64, dtype=np.float64) * s, "b": np.ones(3) * s})
    damage(mgr, kind, 2)
    port, ref = CheckpointManager(tmp_path), RefManager(tmp_path)
    assert port.latest_step() == ref.latest_step() == 1
    assert port.valid_steps() == [1]
    with pytest.raises(CorruptCheckpointError):
        port.restore_arrays(step=2)
    with pytest.raises(CorruptCheckpointError):
        port.restore({"b": torch.zeros(3, dtype=torch.float64),
                      "w": torch.zeros(64, dtype=torch.float64)}, step=2, device="cpu")
    arrays, step = port.restore_arrays()
    assert step == 1 and np.array_equal(arrays["b"], np.ones(3))
    restored, step = port.restore({"b": torch.zeros(3, dtype=torch.float64),
                                   "w": torch.zeros(64, dtype=torch.float64)}, device="cpu")
    assert step == 1 and torch.equal(restored["w"], torch.arange(64, dtype=torch.float64))
    with pytest.raises(CorruptCheckpointError):
        port.verify_step(99)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore_arrays()


def test_keep_async_and_the_pre_commit_window(tmp_path):
    """``keep`` prunes the oldest steps; ``save_async`` snapshots to the host
    and commits on a thread; a crash in the pre-commit window leaves a step
    without a manifest, which no reader takes."""
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in range(1, 5):
        mgr.save(s, {"x": torch.full((3,), float(s))})
    assert mgr.all_steps() == [3, 4]
    x = torch.full((3,), 5.0)
    mgr.save_async(5, {"x": x})
    x += 100  # the snapshot was taken before the thread ran
    arrays, step = mgr.restore_arrays()
    assert step == 5 and np.array_equal(arrays["x"], np.full(3, 5.0))
    assert RefManager(tmp_path).latest_step() == 5

    def crash():
        raise RuntimeError("power cut")

    mgr._pre_commit = crash
    with pytest.raises(RuntimeError, match="power cut"):
        mgr.save(6, {"x": torch.zeros(3)})
    assert mgr._path(6).exists() and not mgr._manifest_path(6).exists()
    assert mgr.latest_step() == 5 and RefManager(tmp_path).latest_step() == 5


def test_frames_equal_the_reference_and_reject_alike():
    """``frame_payload`` gives the reference's bytes; short, bad-magic, CRC
    and torn blobs raise ``CorruptRecordError`` in both packages."""
    payload = b"hello wal"
    assert PW.frame_payload(payload) == RW.frame_payload(payload)
    assert PW.unframe_payload(RW.frame_payload(payload)) == payload
    blob = bytearray(PW.frame_payload(payload))
    blob[-1] ^= 0xFF
    for bad in (b"GW", b"XXXX" + PW.frame_payload(payload)[4:], bytes(blob),
                PW.frame_payload(payload)[:-3]):
        with pytest.raises(PW.CorruptRecordError):
            PW.unframe_payload(bad)
        with pytest.raises(RW.CorruptRecordError):
            RW.unframe_payload(bad)
