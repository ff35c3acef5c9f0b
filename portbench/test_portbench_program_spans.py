"""The readers of the program's own spans and counts: each on a made-up
record and ring, and a traced run of each cell on the CPU at a small size,
where the span and count readers find their numbers and the device twins'
readers find none."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import pb_harness  # noqa: E402
import pb_manifest  # noqa: E402
from test_portbench_faults import run, small  # noqa: E402

SPANS = {  # reader -> the span it reads
    "join_merge_ms": "join.merge",
    "join_refine_ms": "join.refine",
    "descent_dev_ms": "probe.descent.device",
    "probe_dev_ms": "probe.device",
}
COUNTS = ("host_syncs_per_query", "host_sync_wait_ms", "join_group_width")


def reader(name: str):
    return pb_manifest.load_module("metrics", name).read


def fill_ring(counts: list, qid: str = "window") -> None:
    """One finished trace a batch in the program's ring, with these counts."""
    from repro_torch.obs.trace import TRACER

    for i, c in enumerate(counts):
        with TRACER.trace_query((qid, i)) as tr:
            tr.add_count(**c)


@pytest.fixture
def ring():
    from repro_torch.obs.trace import TRACER

    old = TRACER.trace_rate
    TRACER.trace_rate = 1.0
    TRACER.clear()
    yield fill_ring
    TRACER.trace_rate = old
    TRACER.clear()


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_means_the_batch_sums(name):
    span = SPANS[name]
    rec = pb_harness.Record(stage_s=[{span: 0.004, "join": 0.01}, {span: 0.002}, {"join": 0.01}])
    assert reader(name)(rec) == pytest.approx(3.0)  # ms, over the batches that have it
    assert reader(name)(pb_harness.Record(stage_s=[{"join": 0.01}])) is None
    assert reader(name)(pb_harness.Record()) is None


def test_count_readers_read_the_window_traces(ring):
    ring([dict(host_syncs=999, host_sync_s=9.0, queries=1, join_groups=1)] * 3)  # an earlier run
    ring([dict(host_syncs=10), dict(host_syncs=1)], qid="slice")
    ring([dict(host_syncs=30, host_sync_s=0.004, queries=2, join_groups=2),
          dict(host_syncs=50, host_sync_s=0.002, queries=6, join_groups=1)])
    ring([dict(host_syncs=7)], qid="slice")
    rec = pb_harness.Record(stage_s=[{}, {}])  # a window of two batches
    assert reader("host_syncs_per_query")(rec) == pytest.approx(80 / 8)
    assert reader("host_sync_wait_ms")(rec) == pytest.approx(3.0)
    assert reader("join_group_width")(rec) == pytest.approx(8 / 3)


def test_count_readers_find_nothing_without_counts(ring):
    ring([dict(host_syncs=4, host_sync_s=0.001, queries=2)] * 2)
    rec = pb_harness.Record(stage_s=[{}, {}])
    assert reader("join_group_width")(rec) is None  # the host join forms no groups
    assert reader("host_syncs_per_query")(rec) == pytest.approx(2.0)
    ring([{}, {}])  # a program whose traces carry no counts
    for name in COUNTS:
        assert reader(name)(rec) is None
    assert reader("host_syncs_per_query")(pb_harness.Record()) is None


@pytest.mark.parametrize("cell", ["pe50k.q8", "pge20.q5"])
def test_traced_cpu_run_reads_the_program_spans_and_counts(cell, ring):
    result, rec = run(small(cell), trace=True)
    assert result["correct"]
    got = result["metrics"]
    want = {"join_merge_ms", "join_refine_ms", "host_syncs_per_query", "host_sync_wait_ms"}
    if cell == "pge20.q5":
        want.add("join_group_width")
    assert want <= set(got)
    assert not set(got) & {"descent_dev_ms", "probe_dev_ms"}  # no card, no twin
    merged = got["join_merge_ms"]["value"] + got["join_refine_ms"]["value"]
    join = sum(s["join"] for s in rec.stage_s) / len(rec.stage_s) * 1e3
    assert 0 < merged <= join
    assert got["host_syncs_per_query"]["value"] > 1
    if cell == "pge20.q5":
        assert got["join_group_width"]["value"] >= 1
