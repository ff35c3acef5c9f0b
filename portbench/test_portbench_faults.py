"""A run on the CPU at a small size, the harness's look for a card
skipped: sound, ``correct`` holds; with the timed path broken underneath,
or with the control in the program's place, it does not."""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import pb_harness  # noqa: E402
import pb_manifest  # noqa: E402

SEED = 2**31 + 9


def small(cell_name: str) -> pb_manifest.Cell:
    """The cell at a size a test can hold: 500 vertices, 4 labels, 2
    partitions, 48 queries of the cell's own shape, 16 a batch."""
    c = pb_manifest.cell(cell_name)
    config = json.loads(json.dumps(c.config))
    config["graph"].update(n_vertices=500, n_labels=4)
    config["engine"]["n_partitions"] = 2
    traffic = dict(c.traffic, pool=48, batch=16, warm_batches=1, compare=48)
    return dataclasses.replace(c, config=config, traffic=traffic)


def run(cell, trace=False, program=None, wrap_match=None):
    if program is None:
        program = pb_harness.PortProgram(cell.config["engine"], "cpu")
    return pb_harness.run(cell, SEED, 0.2, trace, time.perf_counter(), program=program,
                          wrap_match=wrap_match)


def half_left_out(match):
    """The batch's second half is never matched: its answers come back empty."""
    def faulty(batch):
        half = len(batch) // 2
        return match(batch[:half]) + [[] for _ in batch[half:]]
    return faulty


def answer_altered(match):
    """One vertex of the first match of each batch is changed where it is made."""
    def faulty(batch):
        got = [list(m) for m in match(batch)]
        for m in got:
            if m:
                m[0] = (m[0][0] + 1,) + tuple(m[0][1:])
                break
        return got
    return faulty


CELLS = ["pe50k.q8", "pge20.q5"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, rec = run(small(cell))
    assert result["correct"] and result["compared"]["compared_queries"]["value"] >= 1
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {"qps", "setup_s"}
    assert rec.queries == result["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [half_left_out, answer_altered])
def test_planted_fault_is_not_correct(cell, fault):
    result, _ = run(small(cell), wrap_match=fault)
    assert not result["correct"]
    assert result["compared"]["mismatched_queries"]["value"] >= 1


@pytest.mark.parametrize("cell", ["pe50k.q8", "pge20.q5"])
def test_control_is_not_correct(cell):
    result, _ = run(small(cell), program=pb_harness.ControlProgram())
    assert not result["correct"]
    assert result["compared"]["spurious_matches"]["value"] >= 1


def test_traced_run_reads_the_spans():
    c = small("pge20.q5")
    result, rec = run(c, trace=True)
    assert result["correct"]
    got = set(result["metrics"])
    assert {"batch_p95_ms", "embed_plan_ms", "probe_join_ms", "leaf_pairs_per_query",
            "build_s"} <= got
    # no card: the device's numbers are not there, never 0
    assert not got & {"device_idle_pct", "k1_roofline", "k2_roofline"}
    assert rec.profile is not None and rec.profile["rooflines"]["k2"]["launches"] == 0


def test_seed_orders_one_pool():
    def key(q):
        return q.edges.tobytes(), q.labels.tobytes()

    c = small("pge20.q5")
    a, b = (pb_harness.make_inputs(c.config, c.traffic, SEED) for _ in range(2))
    other = pb_harness.make_inputs(c.config, c.traffic, SEED + 1)
    assert [key(q) for q in a.pool] == [key(q) for q in b.pool]
    assert sorted(map(key, a.pool)) == sorted(map(key, other.pool))
    assert [key(q) for q in a.pool] != [key(q) for q in other.pool]
    assert [key(q) for q in a.warm] == [key(q) for q in other.warm]
