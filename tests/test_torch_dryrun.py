"""The tools that describe a mesh, held against the JAX package on the CPU:
``launch/mesh.py::make_production_mesh``, ``launch/op_cost.py`` (against
``launch/hlo_cost.py``'s programs), ``launch/roofline.py`` and
``launch/dryrun.py::run_cell``.

A fake process group is process-global, so every check that needs one runs
in a child process, and so does the JAX side that needs 512 host devices;
the children start together (the ``children`` fixture) and each test reads its own.

  * ``make_production_mesh``: the shapes and dim names of the JAX module's
    meshes, (16, 16) and (2, 16, 16), over fake groups of 256 and 512;
  * ``op_cost``: a matmul gives exactly 2·m·k·n, as ``analyze_hlo`` does; an
    8-layer loop L·2m³ (the JAX scan within 1 % of it); a matmul whose rows
    split over a 4-rank fake mesh gives the per-rank flops ``analyze_hlo``
    gives for the same specs on 4 XLA host devices, a quarter of the global
    count (which a counter outside DTensor reports); a reshard inside a
    5-layer loop counts at least 5 collectives; ``dist/collectives.py``'s
    all-gather and its backward count one all-gather and one reduce-scatter
    and no all-reduce (the fake group stands for NCCL); a shard-to-shard
    reshard on a mesh of the card's type counts one all-to-all on this
    CPU-only host (the dry-run's meshes are of that type); a collective
    whose group resolves to no process group raises, naming the op; K6, K5
    and K4 on fake tensors give their formulas' flops; the GNN's edge sums
    over 61 nodes split unevenly over (pod 2 × data 2) of an 8-rank fake
    mesh issue one all-gather and one reduce-scatter forward, and backward
    two all-gathers (the sums' gradient, the nodes again) and one
    reduce-scatter, as over (data 4), not one a mesh dim;
  * ``roofline.model_flops`` equals the JAX function on every (arch, shape)
    of ``all_cells(include_skipped=True, include_extra=True)``, and
    ``terms`` the JAX formula on the same record with the card's constants
    (the memory term on ``bytes``, ``bytes_fused`` the lower bound);
  * ``run_cell`` on smoke configs (bf16, the card's K6 dtype) of gemma3-1b
    ``train_4k``, deepseek-v2-lite-16b ``prefill_32k`` (MoE), dcn-v2
    ``serve_bulk``, graphsage-reddit ``minibatch_lg`` and gin-tu
    ``full_graph_sm`` (the edge sums on DTensors) on a (2, 2) fake
    mesh, and of the dcn-v2 and graphsage cells on a (2, 2, 2) one: status
    ``ok`` on a mesh of the card's type, the JAX record's keys less the
    XLA-only ones, ``model_params``
    and ``model_params_active`` equal to the JAX ``run_cell``'s helpers'.
    The LM cells stay on (2, 2): this PyTorch's DTensor (2.13) takes 100 to
    290 s to plan a 3-D mesh's matmul strategies for one smoke LM step
    (5 to 7 s with the 2.11 of the card's host); ``chip_smoke.py`` phase 16
    runs an LM on the (2, 16, 16) mesh there.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro_torch.kernels.cross_interact import ops as ci  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.star_agg import ops as sa  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch.op_cost import analyze_step  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
M, K, N = 64, 128, 32
CELLS = {(2, 2): [("gemma3-1b", "train_4k"), ("deepseek-v2-lite-16b", "prefill_32k"),
                  ("dcn-v2", "serve_bulk"), ("graphsage-reddit", "minibatch_lg"),
                  ("gin-tu", "full_graph_sm")],
         (2, 2, 2): [("dcn-v2", "serve_bulk"), ("graphsage-reddit", "minibatch_lg")]}
# the JAX record's keys, and those only XLA has (its compile: lower_s / compile_s
# are trace_s here; the raw cost analysis; the HLO text's size)
JAX_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s", "n_devices", "memory",
            "flops", "bytes", "bytes_fused", "collective_bytes", "collective_bytes_total",
            "collective_count", "xla_flops_raw", "xla_bytes_raw", "model_params",
            "model_params_active", "hlo_bytes"}
XLA_ONLY = {"lower_s", "compile_s", "xla_flops_raw", "xla_bytes_raw", "hlo_bytes"}

TORCH_CHILD = textwrap.dedent(f"""
    import json
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.dist import collectives as coll
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.launch.op_cost import analyze_step

    out = {{}}
    fake_group(4)
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("d",))
    a = distribute_tensor(torch.zeros({M}, {K}), mesh, [Shard(0)])
    b = distribute_tensor(torch.zeros({K}, {N}), mesh, [Replicate()])
    out["sharded_matmul"] = analyze_step(lambda x, y: x @ y, a, b, real=True)["flops"]
    with FlopCounterMode(display=False) as fc:
        a @ b
    out["outside_dtensor"] = fc.get_total_flops()

    L, m = 5, 16
    x = distribute_tensor(torch.zeros(m, m), mesh, [Shard(0)])
    ws = distribute_tensor(torch.zeros(L, m, m), mesh, [Shard(2)])

    def loop(x, ws):
        for i in range(L):
            x = (x @ ws[i]).redistribute(mesh, [Replicate()])
        return x.sum()

    out["loop_collectives"] = analyze_step(loop, x, ws, real=True)["collective_count"]

    g = torch.zeros(8, 4, requires_grad=True)
    group = mesh.get_group("d")

    def gather_and_back(g):
        coll.all_gather(g, group).sum().backward()

    out["collectives_py"] = analyze_step(gather_and_back, g)["collective_bytes"]

    card = make_mesh((4,), ("d",))  # the card's device type over the fake group, on this host
    y = distribute_tensor(torch.empty(16, 8, device="meta"), card, [Shard(0)])
    out["reshard"] = [card.device_type, analyze_step(
        lambda t: t.redistribute(card, [Shard(1)]).to_local(), y, real=True)["collective_bytes"]]

    from repro_torch.models.gnn import _edge_sums, _gin_messages

    fake_group(8)
    out["edge_sums"] = {{}}
    for shape, names in (((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        em = make_mesh(shape, names)
        rows = [Shard(0)] * (len(shape) - 1) + [Replicate()]
        h = distribute_tensor(torch.empty(61, 8, device="meta"), em, rows)  # 61: uneven blocks
        ei = distribute_tensor(torch.empty(201, 2, dtype=torch.int32, device="meta"), em, rows)

        def sums_and_back(h, ei):
            h = h.detach().requires_grad_(True)
            s = _edge_sums(_gin_messages, 1, None, h, None, ei, None, 64)[0]
            torch.autograd.grad(s.to_local().sum(), [h])

        fw = analyze_step(lambda h, ei: _edge_sums(_gin_messages, 1, None, h, None, ei, None, 64),
                          h, ei)
        bw = analyze_step(sums_and_back, h, ei)
        out["edge_sums"][str(shape)] = [fw["collective_count"], fw["collective_bytes"],
                                        bw["collective_count"]]

    for world, multi in ((256, False), (512, True)):
        fake_group(world)
        pm = make_production_mesh(multi_pod=multi, device="cpu")
        out[str(world)] = [list(pm.shape), list(pm.mesh_dim_names)]
    print("RESULT " + json.dumps(out))
""")

JAX_CHILD = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json
    import jax, jax.numpy as jnp
    import repro.dist  # installs AxisType/make_mesh compat on older jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_arch, resolve_config
    from repro.launch.dryrun import _params_active, _params_count
    from repro.launch.hlo_cost import analyze_hlo
    from repro.launch.mesh import make_production_mesh

    out = {{}}
    for world, multi in ((256, False), (512, True)):
        pm = make_production_mesh(multi_pod=multi)
        out[str(world)] = [list(pm.devices.shape), list(pm.axis_names)]
    mesh = Mesh(jax.devices()[:4], ("d",))
    hlo = jax.jit(lambda x, y: x @ y,
                  in_shardings=(NamedSharding(mesh, P("d", None)), NamedSharding(mesh, P()))).lower(
        jax.ShapeDtypeStruct(({M}, {K}), jnp.float32),
        jax.ShapeDtypeStruct(({K}, {N}), jnp.float32)).compile().as_text()
    out["sharded_matmul"] = analyze_hlo(hlo)["flops"]
    cells = {json.dumps(sorted({c for cells in CELLS.values() for c in cells}))}
    out["params"] = {{}}
    for name, shape in cells:
        arch = get_arch(name)
        cfg = resolve_config(arch, arch.cell(shape), smoke=True)
        out["params"][name + "/" + shape] = [_params_count(cfg, arch), _params_active(cfg, arch)]
    print("RESULT " + json.dumps(out))
""")

CELL_CHILD = textwrap.dedent("""
    import json, sys
    from repro_torch.launch.dryrun import run_cell

    shape = tuple(json.loads(sys.argv[1]))
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    recs = [run_cell(a, s, "single" if len(shape) == 2 else "multi", None, smoke=True,
                     mesh_shape=(shape, names)) for a, s in json.loads(sys.argv[2])]
    print("RESULT " + json.dumps(recs))
""")


class _Child:
    def __init__(self, code, args=(), env=None):
        self.proc = subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out = None

    def result(self):
        if self.out is None:
            try:
                so, se = self.proc.communicate(timeout=300)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
                    self.proc.wait()
            lines = [ln for ln in so.splitlines() if ln.startswith("RESULT ")]
            assert self.proc.returncode == 0 and lines, se[-4000:]
            self.out = json.loads(lines[-1][len("RESULT "):])
        return self.out


@pytest.fixture(scope="module")
def children():
    base = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(SRC),
            "OMP_NUM_THREADS": "1", "HOME": os.environ.get("HOME", "/tmp")}
    if "TMPDIR" in os.environ:
        base["TMPDIR"] = os.environ["TMPDIR"]
    kids = {
        "torch": _Child(TORCH_CHILD, env=base),
        "jax": _Child(JAX_CHILD, env={**base, "JAX_PLATFORMS": "cpu"}),
        **{shape: _Child(CELL_CHILD, (json.dumps(shape), json.dumps(cells)),
                         env={**base, "REPRO_OVERRIDES": "dtype=bfloat16"})
           for shape, cells in CELLS.items()},
    }
    yield kids
    for k in kids.values():
        if k.proc.poll() is None:
            k.proc.kill()
            k.proc.wait()


def test_make_production_mesh_shapes_and_names_equal_the_jax_modules(children):
    got, want = children["torch"].result(), children["jax"].result()
    assert got["256"] == want["256"] == [[16, 16], ["data", "model"]]
    assert got["512"] == want["512"] == [[2, 16, 16], ["pod", "data", "model"]]


def test_matmul_flops_exact_as_analyze_hlo():
    hlo = jax.jit(lambda a, b: a @ b).lower(jnp.zeros((M, K)), jnp.zeros((K, N))).compile()
    want = analyze_hlo(hlo.as_text())["flops"]
    got = analyze_step(lambda a, b: a @ b, torch.zeros(M, K), torch.zeros(K, N))
    assert got["flops"] == want == 2 * M * K * N
    assert got["bytes"] == 4 * (M * K + K * N + M * N)


def test_layer_loop_counts_every_layer():
    L, m = 8, 32

    def f(x, ws):
        for i in range(L):
            x = torch.tanh(x @ ws[i])
        return x

    def jf(x, ws):
        return jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)[0]

    got = analyze_step(f, torch.zeros(m, m), torch.zeros(L, m, m))["flops"]
    hlo = jax.jit(jf).lower(jnp.zeros((m, m)), jnp.zeros((L, m, m))).compile().as_text()
    assert got == L * 2 * m**3
    assert abs(analyze_hlo(hlo)["flops"] - got) <= 0.01 * got


def test_sharded_matmul_counts_per_rank_flops_as_xla_does_not_the_global_op(children):
    got, want = children["torch"].result(), children["jax"].result()
    assert got["sharded_matmul"] == want["sharded_matmul"] == 2 * M * K * N / 4
    assert got["outside_dtensor"] == 2 * M * K * N  # trap: the global op


def test_reshard_in_a_5_layer_loop_counts_5_collectives(children):
    assert children["torch"].result()["loop_collectives"] >= 5


def test_collectives_py_reduce_scatter_is_counted_as_one(children):
    got = children["torch"].result()["collectives_py"]
    assert set(got) == {"all-gather", "reduce-scatter"}, got
    assert got["all-gather"] == 4 * 8 * 4 * 4  # the gathered (32, 4) float32 rows
    assert got["reduce-scatter"] == 8 * 4 * 4  # this rank's (8, 4) block


def test_edge_sums_over_pod_x_data_issue_one_gather_and_one_reduction(children):
    # nodes split over (pod, data) gather and reduce in one collective each over the 4 ranks
    # as one group, as over one data dim of 4: not one a mesh dim; 61 nodes split unevenly
    got = children["torch"].result()["edge_sums"]
    one, pod = got[str((4, 2))], got[str((2, 2, 2))]
    assert one[0] == pod[0] == 2, (one, pod)
    assert one[1] == pod[1] == {"all-gather": 4 * 16 * 8 * 4,  # 4 blocks padded to 16 rows
                                "reduce-scatter": 16 * 8 * 4}, (one, pod)
    # with the backward: the sums' gradient gathered, the nodes gathered again (the gather is
    # checkpointed with the sums) and their gradient reduce-scattered
    assert one[2] == pod[2] == 5, (one, pod)


def test_shard_to_shard_reshard_is_counted_as_an_all_to_all_on_any_host(children):
    # a mesh of the CPU's type would plan gloo's all-gather and chunk instead
    device_type, got = children["torch"].result()["reshard"]
    assert device_type == "cuda"
    assert got == {"all-to-all": 16 * 2 * 4}  # this rank's (16, 2) float32 block


def test_a_collective_whose_group_cannot_be_resolved_raises_naming_the_op():
    # its ranks, and so its bytes, are unknown: counting it as some size would guess
    x = torch.empty(4, 4, device="meta")
    with pytest.raises(RuntimeError, match=r"_c10d_functional\.all_reduce.*cannot be resolved"):
        analyze_step(lambda t: torch.ops._c10d_functional.all_reduce(t, "sum", "no-such-group"), x)


@pytest.mark.parametrize("window", [None, 24])
def test_kernels_on_fake_tensors_count_their_formulas(window):
    B, S, Hq, Hkv, dh, dv = 2, 64, 4, 2, 32, 16
    q, k, v = torch.zeros(B, S, Hq, dh), torch.zeros(B, S, Hkv, dh), torch.zeros(B, S, Hkv, dv)
    got = analyze_step(lambda *t: fa.flash_attention(*t, window=window), q, k, v)
    w = S if window is None else window
    pairs = w * (w + 1) // 2 + (S - w) * w
    assert got["flops"] == fa.attention_flops(B, S, Hq, dh, dv, True, window) \
        == 2 * (dh + dv) * pairs * B * Hq
    assert got["n_ops"] == 1 and got["bytes"] == 4 * (q.numel() + k.numel() + 3 * v.numel())
    x = torch.zeros(8, 5)
    assert analyze_step(ci.cross_interact, x, x, torch.zeros(5, 5), torch.zeros(5))["flops"] \
        == 2 * 8 * 5 * 5
    idx, mask = torch.zeros(8, 3, dtype=torch.int32), torch.ones(8, 3, dtype=torch.bool)
    assert analyze_step(sa.star_agg, idx, mask, torch.zeros(10, 4))["flops"] == 8 * 2 * 4


def test_roofline_model_flops_equals_the_jax_function_on_every_cell():
    cells = jcfg.all_cells(include_skipped=True, include_extra=True)
    assert len(cells) == 42
    for i, (arch, cell) in enumerate(cells):
        rec = {"arch": arch.name, "shape": cell.name, "model_params": 1_000_003 * (i + 1),
               "model_params_active": 700_001 * (i + 1)}
        assert troof.model_flops(rec) == jroof.model_flops(rec), (arch.name, cell.name)


def test_roofline_terms_are_the_jax_formula_with_the_cards_constants(monkeypatch):
    rec = {"arch": "gemma3-1b", "shape": "train_4k", "n_devices": 256, "flops": 3.1e14,
           "bytes": 9.0e12, "bytes_fused": 2.0e12, "model_params": 999_812_736,
           "model_params_active": 999_812_736, "memory": {"peak_memory_in_bytes": 9.1e10},
           "collective_bytes": {"all-gather": 4e11, "all-reduce": 1e11, "reduce-scatter": 3e10}}
    monkeypatch.setattr(jroof, "PEAK_FLOPS", 989e12)
    monkeypatch.setattr(jroof, "HBM_BW", 3.35e12)
    monkeypatch.setattr(jroof, "ICI_BW", 50e9)
    got = troof.terms(rec)
    want = jroof.terms({**rec, "bytes_fused": rec["bytes"]})  # the memory term on bytes
    lower = jroof.terms(rec)
    for k in ("compute_s", "collective_s", "dominant", "model_flops_global", "useful_ratio",
              "roofline_frac", "peak_gb", "memory_s"):
        assert got[k] == want[k], k
    assert got["memory_lb_s"] == lower["memory_s"]
    assert got["fits"] is False  # 91 GB > 80


@pytest.mark.parametrize("shape", list(CELLS))
def test_run_cell_on_fake_meshes_records_the_jax_keys(children, shape):
    recs = children[shape].result()
    params = children["jax"].result()["params"]
    assert [(r["arch"], r["shape"]) for r in recs] == CELLS[shape]
    for rec in recs:
        what = (rec["arch"], rec["shape"], shape)
        assert rec["status"] == "ok", (what, rec.get("error"), rec.get("traceback"))
        assert JAX_KEYS - XLA_ONLY <= set(rec) and "trace_s" in rec, what
        assert rec["n_devices"] == int(np.prod(shape)) and rec["mesh_device"] == "cuda"
        assert set(rec["memory"]) == {"argument_size_in_bytes", "peak_memory_in_bytes"}
        assert 0 < rec["memory"]["argument_size_in_bytes"] <= rec["memory"]["peak_memory_in_bytes"]
        assert rec["flops"] > 0 and rec["bytes"] >= rec["bytes_fused"] > 0
        assert rec["collective_bytes_total"] == sum(rec["collective_bytes"].values())
        assert [rec["model_params"], rec["model_params_active"]] == \
            params[rec["arch"] + "/" + rec["shape"]], what
