"""The port's training substrate on the CPU, mirroring the JAX package's
``tests/test_runtime.py`` one for one: AdamW and its schedule, checkpoint
atomicity, resume and elasticity, the trainer loop, the straggler hook,
preemption, gradient compression, wire bytes and the data pipelines.  The
data and compression tests also hold the port to the JAX package on the
same inputs: every batch bit-identical for each (seed, step), and the
compressed gradients within 1e-6 of the reference's (top-k keeps every
entry at or above its threshold, so which of tied indices the top-k picked
does not matter).
"""
import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import (  # noqa: E402
    GraphTaskData,
    LMSyntheticData,
    Prefetcher,
    RecsysSyntheticData,
)
from repro_torch.dist.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.compress import (  # noqa: E402
    CompressionConfig,
    compress_grads,
    init_residual,
    wire_bytes,
)
from repro_torch.train.optimizer import (  # noqa: E402
    OptConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
)
from repro_torch.train.functional import tree_to_device  # noqa: E402
from repro_torch.train.step import train_wrap  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: test files run in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- optimizer ---


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    cfg = OptConfig(lr=0.2, warmup_steps=0, total_steps=200, weight_decay=0.0, clip_norm=100.0)
    for _ in range(200):
        params, opt, _ = adamw_update({"w": 2 * params["w"]}, opt, params, cfg)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 200


def test_cosine_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s))) for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1)


# ------------------------------------------------------------ checkpoint ---


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": torch.tensor(7)}
    for s in [1, 2, 3]:
        mgr.save(s, state)
    assert mgr.all_steps() == [2, 3]  # gc keeps the last 2
    restored, step = mgr.restore(state, device="cpu")
    assert step == 3
    assert torch.equal(restored["params"]["w"], state["params"]["w"])


def test_checkpoint_async_and_atomic(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(10, {"w": torch.ones((128, 128))})
    mgr.wait()
    assert mgr.latest_step() == 10
    assert not list(tmp_path.glob("*.tmp"))  # staging cleaned up


def test_checkpoint_elastic_restore_different_sharding(tmp_path):
    """Written from one placement, restored onto the device the caller
    names (the port's counterpart of the reference's explicit shardings)."""
    mgr = CheckpointManager(tmp_path)
    state = {"w": torch.arange(64.0).reshape(8, 8)}
    mgr.save(1, state)
    restored, _ = mgr.restore({"w": torch.zeros(8, 8, dtype=torch.float64)}, device="cpu")
    assert restored["w"].dtype == torch.float64 and restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], state["w"].double())


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.ones(5)}, device="cpu")


# ---------------------------------------------------------------- trainer --


def _toy_loss(params, batch):
    pred = batch["x"] @ params["w"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {}


def _toy_batch(step):
    rng = np.random.default_rng(step)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    w_true = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    return {"x": x, "y": x @ w_true}


def test_trainer_step_is_train_wrap_with_grad_accum(tmp_path):
    """The Trainer's step is ``train_wrap``'s, microbatches included: on a
    loss that is no mean over rows, two microbatches give other params
    than one batch, and the Trainer's equal ``train_wrap``'s to the bit."""
    def loss(params, batch):
        return torch.sqrt(torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)), {}

    opt = OptConfig(lr=0.05, warmup_steps=0, total_steps=6, weight_decay=0.0)
    cfg = TrainerConfig(total_steps=6, ckpt_every=100, ckpt_dir=str(tmp_path), opt=opt,
                        grad_accum=2)
    tr = Trainer(loss, {"w": torch.zeros(4)}, _toy_batch, cfg)
    tr.run()
    out = {}
    for accum in (1, 2):
        step = train_wrap(loss, opt, accum)
        p = {"w": torch.zeros(4)}
        s = adamw_init(p)
        for i in range(6):
            p, s, _ = step(p, s, tree_to_device(_toy_batch(i), torch.device("cpu")))
        out[accum] = p["w"]
    assert torch.equal(tr.params["w"], out[2])
    assert not torch.allclose(out[1], out[2])


def test_trainer_loss_decreases_and_checkpoints(tmp_path):
    cfg = TrainerConfig(
        total_steps=60, ckpt_every=20, ckpt_dir=str(tmp_path), log_every=100,
        opt=OptConfig(lr=0.05, warmup_steps=0, total_steps=60, weight_decay=0.0),
    )
    tr = Trainer(_toy_loss, {"w": torch.zeros(4)}, _toy_batch, cfg)
    out = tr.run()
    assert out["final_loss"] < tr.history[0]["loss"] * 0.2
    assert tr.ckpt.latest_step() is not None


def test_trainer_resume_reproduces_exact_state(tmp_path):
    def cfg_for(d):
        return TrainerConfig(
            total_steps=40, ckpt_every=20, ckpt_dir=str(tmp_path / d), async_checkpoint=False,
            opt=OptConfig(lr=0.05, warmup_steps=0, total_steps=40, weight_decay=0.0),
        )

    tr1 = Trainer(_toy_loss, {"w": torch.zeros(4)}, _toy_batch, cfg_for("a"))
    tr1.run(40)
    tr2 = Trainer(_toy_loss, {"w": torch.zeros(4)}, _toy_batch, cfg_for("b"))
    tr2.run(20)
    tr3 = Trainer(_toy_loss, {"w": torch.zeros(4)}, _toy_batch, cfg_for("b"))
    assert tr3.try_resume()
    assert tr3.step == 20
    tr3.run(20)
    # deterministic ops on the CPU: the resumed run is bit for bit the straight one
    assert torch.equal(tr1.params["w"], tr3.params["w"])
    assert all(torch.equal(a, b) for a, b in ((tr1.opt_state["m"]["w"], tr3.opt_state["m"]["w"]),
                                               (tr1.opt_state["v"]["w"], tr3.opt_state["v"]["w"])))


def test_trainer_straggler_watchdog(tmp_path):
    cfg = TrainerConfig(total_steps=30, ckpt_every=1000, ckpt_dir=str(tmp_path), deadline_factor=3.0)
    slow = {"hit": False}

    def loss(params, batch):
        if int(batch["step"]) == 25 and not slow["hit"]:
            slow["hit"] = True
            time.sleep(0.5)  # injected straggler, inside the timed step
        return _toy_loss(params, batch)

    tr = Trainer(loss, {"w": torch.zeros(4)},
                 lambda s: {**_toy_batch(s), "step": np.asarray(s)}, cfg)
    out = tr.run()
    assert out["stragglers"] >= 1
    assert any(e["step"] == 25 for e in tr.straggler_events)


def test_trainer_preemption_checkpoints(tmp_path):
    cfg = TrainerConfig(total_steps=1000, ckpt_every=10_000, ckpt_dir=str(tmp_path))
    tr = Trainer(_toy_loss, {"w": torch.zeros(4)}, _toy_batch, cfg)
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    tr.install_preemption_handler()

    def batch_fn(step):
        if step == 15:
            os.kill(os.getpid(), signal.SIGTERM)  # simulated preemption
        return _toy_batch(step)

    tr.batch_fn = batch_fn
    try:
        out = tr.run()
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    assert out["preempted"]
    assert tr.ckpt.latest_step() == out["final_step"]


# ------------------------------------------------------------ compression --


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_error_feedback_unbiased(kind):
    """With error feedback the cumulative compressed signal tracks the
    cumulative true gradient; each round equals the reference's codec."""
    import jax.numpy as jnp

    from repro.train import compress as ref

    cfg = CompressionConfig(kind=kind, topk_frac=0.25)
    g_np = np.random.default_rng(0).normal(size=(64,)).astype(np.float32)
    g = {"w": torch.from_numpy(g_np)}
    res = init_residual(g)
    rres = ref.init_residual({"w": jnp.asarray(g_np)})
    total = torch.zeros(64)
    for _ in range(50):
        sent, res = compress_grads(g, res, cfg)
        rsent, rres = ref.compress_grads({"w": jnp.asarray(g_np)}, rres,
                                         ref.CompressionConfig(kind=kind, topk_frac=0.25))
        np.testing.assert_allclose(sent["w"].numpy(), np.asarray(rsent["w"]), atol=1e-6)
        total = total + sent["w"]
    np.testing.assert_allclose(total.numpy() / 50, g_np, atol=0.12)


def test_compression_training_still_converges(tmp_path):
    cfg = TrainerConfig(
        total_steps=250, ckpt_every=10_000, ckpt_dir=str(tmp_path),
        opt=OptConfig(lr=0.05, warmup_steps=0, total_steps=250, weight_decay=0.0),
        compression=CompressionConfig(kind="int8"),
    )
    tr = Trainer(_toy_loss, {"w": torch.zeros(4)}, _toy_batch, cfg)
    out = tr.run()
    assert out["final_loss"] < 0.3  # int8 noise slows but must not stall it (init ~14)


def test_wire_bytes():
    params = {"w": torch.zeros(1000)}
    assert wire_bytes(params, CompressionConfig("none")) == 4000
    assert wire_bytes(params, CompressionConfig("int8")) == 1000
    assert wire_bytes(params, CompressionConfig("topk", topk_frac=0.01)) == 80


# ------------------------------------------------------------------ data ---


def test_data_determinism_and_prefetch():
    from repro.data.pipeline import LMSyntheticData as RefLM

    d = LMSyntheticData(vocab=100, batch=4, seq_len=16, seed=3)
    b1, b2 = d.batch_at(7), d.batch_at(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(d.batch_at(8)["tokens"], b1["tokens"])
    ref = RefLM(vocab=100, batch=4, seq_len=16, seed=3).batch_at(7)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b1[k], ref[k])
    pf = Prefetcher(d.batch_at, start_step=5)
    s, b = pf.next()
    assert s == 5
    np.testing.assert_array_equal(b["tokens"], d.batch_at(5)["tokens"])
    pf.stop()


def test_recsys_data_learnable_signal():
    from repro.data.pipeline import RecsysSyntheticData as RefRecsys
    from repro.models import RecsysConfig as RefRecsysConfig
    from repro_torch.models import RecsysConfig

    d = RecsysSyntheticData(RecsysConfig(vocab_per_field=100), batch=4096, seed=0)
    b = d.batch_at(0)
    cross = (b["sparse"][:, 0] % 7 == b["sparse"][:, 1] % 7).astype(float)
    assert np.corrcoef(cross, b["label"])[0, 1] > 0.1
    ref = RefRecsys(RefRecsysConfig(vocab_per_field=100), batch=4096, seed=0).batch_at(0)
    for k in ("dense", "sparse", "label"):
        np.testing.assert_array_equal(b[k], ref[k])


def test_graph_task_data():
    from repro.data.pipeline import GraphTaskData as RefGraphTask
    from repro.graphs import erdos_renyi as ref_er
    from repro_torch.graphs import erdos_renyi

    g = erdos_renyi(100, avg_degree=4, n_labels=3, seed=0)
    b = GraphTaskData(g, d_feat=8, n_classes=4, seed=0).full_batch()
    assert b["node_feat"].shape == (100, 8)
    assert b["labels"].max() < 4
    ref = RefGraphTask(ref_er(100, avg_degree=4, n_labels=3, seed=0), d_feat=8, n_classes=4,
                       seed=0).full_batch()
    for k in ("node_feat", "edge_index", "labels"):
        np.testing.assert_array_equal(b[k], ref[k])
