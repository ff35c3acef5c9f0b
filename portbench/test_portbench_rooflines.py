"""The kernels' work counts on hand-worked shapes, the reduction of a
profiler slice, and the metric readers on a hand-made record."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import pb_manifest  # noqa: E402
from pb_bounds import FP32_OPS_PER_S, HBM_BYTES_PER_S, bound_s  # noqa: E402
from pb_harness import Record  # noqa: E402
from pb_trace import Event, reduce_slice, short_name  # noqa: E402

K1 = pb_manifest.load_module("rooflines", "k1")
K2 = pb_manifest.load_module("rooflines", "k2")


class Seg:
    def __init__(self, rows, q_ids, data, query):
        self.rows, self.q_ids, self.data, self.query = rows, q_ids, data, query


def side(n: int, labels) -> tuple:
    multi = torch.zeros(2, n, 2)
    return (torch.zeros(n, 2), multi[0], multi[1], torch.tensor(labels, dtype=torch.float32))


def test_k1_pairs_count():
    # pairs (0, 0), (0, 1) pass the labels, (1, 0) does not; D = 3 tables x 2, D0 = 1
    seg = Seg(torch.tensor([0, 0, 1]), torch.tensor([0, 1, 0]),
              side(2, [[0.0], [5.0]]), side(2, [[0.0], [0.0]]))
    n_bytes, n_ops = K1.work(K1.keep("dominance_scan_pairs_indexed", ([seg],), {"eps": 1e-6}))
    # 17 a pair; labels of rows {0, 1} and queries {0, 1}; dominance of row 0, queries 0, 1
    assert n_bytes == 17 * 3 + 2 * 4 + 2 * 4 + 3 * 4 * 6
    assert n_ops == 3 * 3 * 1 + 2 * 2 * 6


def test_k1_groups_count():
    lo_hi = torch.tensor([[[0.0, 1.0]], [[2.0, 3.0]]])
    multi = torch.zeros(2, 2, 2)
    data = (torch.zeros(2, 2), multi[0], multi[1], lo_hi)
    seg = Seg(torch.tensor([0, 1, 1]), torch.tensor([0, 0, 1]), data, side(2, [[0.5], [2.5]]))
    n_bytes, n_ops = K1.work(K1.keep("dominance_scan_groups_indexed", ([seg], 1e-6), {}))
    assert n_bytes == 17 * 3 + 2 * 4 * 1 * 2 + 2 * 4 + 4 * 4 * 6
    assert n_ops == 3 * 4 * 1 + 2 * 2 * 6


def test_k1_no_pairs_no_launch():
    seg = Seg(torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64),
              side(1, [[0.0]]), side(1, [[0.0]]))
    assert K1.keep("dominance_scan_pairs_indexed", ([seg],), {}) is None


def test_k2_count():
    table = torch.zeros(10, 5, dtype=torch.int32)
    kept = K2.keep("injectivity_mask", (table[:, :3], table[:, 3:]), {})
    assert kept == (10, 3, 2) and K2.work(kept) == (210.0, 70.0)
    assert K2.keep("injectivity_mask", (table[:, :3], table[:, 5:]), {}) is None
    assert K2.keep("injectivity_mask", (table[:0, :3], table[:0, 3:]), {}) is None


def test_bound_is_the_larger_term():
    assert bound_s(HBM_BYTES_PER_S, 0) == pytest.approx(1.0)
    assert bound_s(0, FP32_OPS_PER_S) == pytest.approx(1.0)
    assert bound_s(HBM_BYTES_PER_S, 2 * FP32_OPS_PER_S) == pytest.approx(2.0)


def test_reduce_slice_union_and_gaps():
    ev = [
        Event("portbench:slice", False, 0, 100),
        Event("span:embed", False, 0, 40), Event("span:join", False, 40, 100),
        Event("span:probe", False, 45, 55),
        Event("void k1<1>(int)", True, 10, 20), Event("void k1<1>(int)", True, 15, 30),
        Event("memcpy", True, 50, 60), Event("late", True, 200, 300),
        Event("early", True, -10, 5),
    ]
    r = reduce_slice(ev)
    assert r["window_s"] == pytest.approx(100e-9)
    assert r["busy_s"] == pytest.approx(35e-9)  # [0, 5] clipped, [10, 30], [50, 60]
    assert r["kernels"]["void k1<1>"] == [pytest.approx(25e-9), 2]  # a sum, not a union
    assert "late" not in r["kernels"]
    gaps = dict(r["idle_gaps"])
    # [5, 10] and [30, 50] in embed (the shorter span at 40), [60, 100] in join
    assert gaps == {"embed": pytest.approx(25e-9), "join": pytest.approx(40e-9)}
    assert reduce_slice(ev[1:]) is None


def test_short_name_drops_arguments():
    assert short_name("void (anonymous namespace)::dominance_scan_indexed_kernel<0, 0, 0, "
                      "false, true>(long const*, int)") == \
        "void dominance_scan_indexed_kernel<0, 0, 0, false, true>"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


def record() -> Record:
    rec = Record(queries=640, window_s=4.0, setup_s=12.5, build_s=3.5,
                 batch_s=[0.5 + 0.01 * i for i in range(20)], leaf_pairs=6400.0)
    rec.stage_s = [{"embed": 0.1, "plan": 0.05, "probe": 0.02, "partition": 0.0,
                    "assemble": 0.03, "join": 0.2}] * 4
    rec.profile = {"window_s": 2.0, "busy_s": 0.1, "kernels": {},
                   "rooflines": {"k1": {"bound_s": 1e-5, "calls": 6, "kernel_s": 4e-5,
                                        "launches": 6},
                                 "k2": {"bound_s": 1e-6, "calls": 5, "kernel_s": 1e-5,
                                        "launches": 4}}}
    return rec


@pytest.mark.parametrize("name,want", [
    ("qps", 160.0), ("setup_s", 12.5), ("build_s", 3.5), ("embed_plan_ms", 150.0),
    ("probe_ms", 20.0), ("join_ms", 230.0), ("probe_join_ms", 250.0),
    ("leaf_pairs_per_query", 10.0), ("device_idle_pct", 95.0), ("k1_roofline", 25.0),
    ("k2_roofline", None),  # the two passes saw different calls: nothing to report
])
def test_readers(name, want):
    got = pb_manifest.load_module("metrics", name).read(record())
    assert got == (None if want is None else pytest.approx(want))


def test_batch_p95():
    got = pb_manifest.load_module("metrics", "batch_p95_ms").read(record())
    assert 680.0 <= got <= 690.0


@pytest.mark.parametrize("name", ["embed_plan_ms", "probe_ms", "join_ms", "probe_join_ms",
                                  "leaf_pairs_per_query", "device_idle_pct", "k1_roofline"])
def test_readers_return_nothing_without_a_trace(name):
    assert pb_manifest.load_module("metrics", name).read(Record(queries=1, window_s=1.0)) is None
