"""The port's production-mesh dry-run held to the JAX package's plan, cell
by cell: ``repro_torch.launch.dryrun.run_cell`` against
``repro.launch.dryrun.run_cell`` on the single (16, 16) mesh and on the
multi-pod (2, 16, 16) mesh, at published width with
``REPRO_OVERRIDES=n_layers=2`` on both sides (every cell's plan shows at
two layers, and two layers trace in seconds).

Children, started together for one mesh (a fake process group is
process-global, and the reference's module asks XLA for 512 host devices
before it imports JAX; its single mesh takes 256): two JAX children and
three torch children, each on its share of the cells; the multi-pod
mesh's start when its first test runs, after the single mesh's.  Per
cell, per device, on each mesh:

  * both sides ``ok``;
  * the port's flops at most 1.5 × the reference's (``op_cost`` against
    ``hlo_cost``, which ``test_torch_dryrun.py`` holds equal on the same
    programs);
  * the port's peak at most 2 × the reference's memory figure (argument +
    output − alias + temp) + 256 MB;
  * for ``decode_32k``, ``long_500k`` and ``online_scan``, the port's
    all-gather bytes at most the reference's all-gather and
    collective-permute bytes + 64 MB: a decode step or an index scan
    moves no cache or index rows;
  * on (2, 16, 16), the port's collective bytes at most its own on
    (16, 16) × max(1.05, the reference's own multi/single ratio) + 64 MB:
    adding a pod halves each device's share of the batch, so it adds no
    traffic to a device unless the reference's plan adds it too (the
    reduction over pod × data in one collective, not one a mesh dim).

Left out, and named by ``test_the_cells_left_out_are_named``: the cells
the registry skips, and dcn-v2's, whose reference raises on its own
``tables`` spec (26 tables do not split over 16 ranks).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
OVERRIDES = "n_layers=2"
GB = 1e9
ALL = jcfg.all_cells(include_skipped=True, include_extra=True)
LEFT_OUT = {(a.name, c.name): f"skipped by the registry: {c.skip}" for a, c in ALL if c.skip}
LEFT_OUT.update({(a.name, c.name): "the reference raises on its own tables spec"
                 for a, c in ALL if a.name == "dcn-v2"})
CELLS = [(a.name, c.name) for a, c in ALL if (a.name, c.name) not in LEFT_OUT]
# cells whose plan moves no cache or index rows: all-gather held to the reference's
NO_GATHER = ("decode_32k", "long_500k", "online_scan")
N_JAX, N_TORCH = 2, 3

JAX_CHILD = textwrap.dedent("""
    import json, sys, tempfile, traceback
    from pathlib import Path
    from repro.launch.dryrun import run_cell  # sets XLA_FLAGS before JAX is imported

    out, d = {}, Path(tempfile.mkdtemp())
    for a, s in json.loads(sys.argv[1]):
        try:
            out[a + "/" + s] = run_cell(a, s, sys.argv[2], d)
        except Exception as e:
            out[a + "/" + s] = {"status": "error", "error": repr(e)[:1000],
                                "traceback": traceback.format_exc()[-2000:]}
    print("RESULT " + json.dumps(out))
""")

TORCH_CHILD = textwrap.dedent("""
    import json, sys
    from repro_torch.launch.dryrun import run_cell

    out = {a + "/" + s: run_cell(a, s, sys.argv[2], None) for a, s in json.loads(sys.argv[1])}
    print("RESULT " + json.dumps(out))
""")


class _Child:
    def __init__(self, code, cells, mesh, env):
        self.proc = subprocess.Popen([sys.executable, "-c", code, json.dumps(cells), mesh],
                                     env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)
        self.out = None

    def result(self) -> dict:
        if self.out is None:
            try:
                so, se = self.proc.communicate(timeout=600)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
                    self.proc.wait()
            lines = [ln for ln in so.splitlines() if ln.startswith("RESULT ")]
            assert self.proc.returncode == 0 and lines, se[-4000:]
            self.out = json.loads(lines[-1][len("RESULT "):])
        return self.out


def _share(n: int, k: int) -> list:
    """Child k's share of the cells when n children split them in turn."""
    return CELLS[k::n]


def _start(mesh: str) -> dict:
    base = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(SRC),
            "OMP_NUM_THREADS": "1", "HOME": os.environ.get("HOME", "/tmp"),
            "REPRO_OVERRIDES": OVERRIDES}
    if "TMPDIR" in os.environ:
        base["TMPDIR"] = os.environ["TMPDIR"]
    return {"jax": [_Child(JAX_CHILD, _share(N_JAX, k), mesh, {**base, "JAX_PLATFORMS": "cpu"})
                    for k in range(N_JAX)],
            "torch": [_Child(TORCH_CHILD, _share(N_TORCH, k), mesh, base)
                      for k in range(N_TORCH)]}


def _stop(kids: dict) -> None:
    for k in kids["jax"] + kids["torch"]:
        if k.proc.poll() is None:
            k.proc.kill()
            k.proc.wait()


@pytest.fixture(scope="module")
def children():
    kids = _start("single")
    yield kids
    _stop(kids)


@pytest.fixture(scope="module")
def multi_children():
    kids = _start("multi")
    yield kids
    _stop(kids)


def _record(kids: list, cell) -> dict:
    i = CELLS.index(cell)
    return kids[i % len(kids)].result()["/".join(cell)]


def _ref_memory(rec: dict) -> int:
    m = rec["memory"]
    return (m["argument_size_in_bytes"] + m["output_size_in_bytes"] - m["alias_size_in_bytes"]
            + m["temp_size_in_bytes"])


def test_the_cells_left_out_are_named():
    assert sorted(LEFT_OUT) == [
        ("command-r-plus-104b", "long_500k"), ("dcn-v2", "retrieval_cand"),
        ("dcn-v2", "serve_bulk"), ("dcn-v2", "serve_p99"), ("dcn-v2", "train_batch"),
        ("minitron-4b", "long_500k"), ("qwen3-moe-235b-a22b", "long_500k")]
    assert len(CELLS) == 35


def _holds(got: dict, want: dict, cell) -> None:
    """The three bounds of the port's record against the reference's (the module doc)."""
    assert want["status"] == "ok", (want.get("error"), want.get("traceback"))
    assert got["status"] == "ok", (got.get("error"), got.get("traceback"))
    assert got["flops"] <= 1.5 * want["flops"], (got["flops"], want["flops"])
    peak, ref = got["memory"]["peak_memory_in_bytes"], _ref_memory(want)
    assert peak <= 2 * ref + 256e6, (peak / GB, ref / GB)
    if cell[1] in NO_GATHER:
        theirs = sum(want["collective_bytes"].get(k, 0.0)
                     for k in ("all-gather", "collective-permute"))
        ours = got["collective_bytes"].get("all-gather", 0.0)
        assert ours <= theirs + 64e6, (ours / GB, theirs / GB)


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_the_port_holds_to_the_reference_plan(children, cell):
    _holds(_record(children["torch"], cell), _record(children["jax"], cell), cell)


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_the_port_holds_to_the_reference_plan_on_the_multi_pod_mesh(children, multi_children,
                                                                    cell):
    got, want = _record(multi_children["torch"], cell), _record(multi_children["jax"], cell)
    _holds(got, want, cell)
    single, ref_single = _record(children["torch"], cell), _record(children["jax"], cell)
    ours = got["collective_bytes_total"]
    ratio = want["collective_bytes_total"] / max(ref_single["collective_bytes_total"], 1.0)
    bound = single["collective_bytes_total"] * max(1.05, ratio) + 64e6
    assert ours <= bound, (ours / GB, single["collective_bytes_total"] / GB, ratio)
