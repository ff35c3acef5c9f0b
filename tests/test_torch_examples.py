"""The port's examples on the CPU, each in a child process with a time-out
(the three start together):

  * ``quickstart_torch.py --device cpu --encoder monotone``: every query's
    match set equal to VF2's (the example raises otherwise; ``monotone``
    skips the GAT's 90 s of training);
  * ``chaos_crash_torch.py --device cpu`` at ``--n 600`` with the kill
    pinned at epoch 3: the victim SIGKILLed, restarted, and its final
    ``[wal] final ...`` line equal to the control's;
  * ``distributed_dryrun_torch.py`` on dcn-v2's smoke ``serve_bulk`` over
    the 512-rank multi-pod fake mesh: the per-device report.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
RUNS = {
    "quickstart": ["quickstart_torch.py", "--device", "cpu", "--encoder", "monotone"],
    "chaos": ["chaos_crash_torch.py", "--device", "cpu", "--n", "600", "--kill-epoch", "3"],
    "dryrun": ["distributed_dryrun_torch.py", "--arch", "dcn-v2", "--shape", "serve_bulk",
               "--smoke"],
}


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {k: subprocess.Popen([sys.executable, str(ROOT / "examples" / v[0]), *v[1:]],
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for k, v in RUNS.items()}
    out = {}
    try:
        for k, p in procs.items():
            so, se = p.communicate(timeout=300)
            out[k] = (p.returncode, so, se)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_quickstart_matches_vf2_on_every_query(runs):
    rc, so, se = runs["quickstart"]
    assert rc == 0, se[-3000:]
    assert so.count("(oracle agrees)") == 3, so


def test_chaos_crash_recovers_to_the_controls_final_line(runs):
    rc, so, se = runs["chaos"]
    assert rc == 0, so[-2000:] + se[-2000:]
    finals = [ln for ln in so.splitlines() if ln.startswith("[wal] final ")]
    assert len(finals) == 2 and finals[0] == finals[1], finals
    assert "[chaos] SIGKILLed victim at epoch 3" in so
    assert "[chaos] ok: recovered replica identical to control" in so


def test_distributed_dryrun_reports_a_smoke_cell(runs):
    rc, so, se = runs["dryrun"]
    assert rc == 0, se[-3000:]
    assert "=== dcn-v2 / serve_bulk on the 512-card mesh ===" in so, so
    assert "per-device FLOPs" in so and "collectives:" in so, so
