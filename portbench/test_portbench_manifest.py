"""The manifest keeps the benchmark's contract, and every name in it
finds its file: configurations, mixes, metric readers, kernel counts."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import pb_manifest  # noqa: E402

M = pb_manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
PER_LAYER = [m["name"] for m in M["per_layer"]]
ALL_METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (pb_manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert len(p) <= 200 and not p.startswith("/") and ".." not in p.split("/")
        assert (pb_manifest.ROOT / p).is_dir()
    assert len(M["command"]) <= 32
    files = [w for w in M["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in M["paths"]) for f in files)


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_valid_and_unique(kind):
    names = [x["name"] for x in M[kind]]
    assert len(names) == len(set(names))
    assert all(pb_manifest.NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in M["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    assert set(metric) - {"workloads"} == keys
    assert pb_manifest.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for w in metric.get("workloads", []):
        assert w in CELLS
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%" and metric["source"] == "device_trace"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c = pb_manifest.cell(cell)
    w = [x for x in M["workloads"] if x["name"] == cell][0]
    conf = [x for x in M["configs"] if x["name"] == w["config"]][0]
    assert c.config["name"] == conf["name"] and c.config["reduced"] == conf["reduced"]
    assert len(c.config["source"]) <= 200 and c.config["source"] == conf["source"]
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for key in ("loop", "clients", "batch", "pool", "pool_seed", "warm_batches",
                "query_vertices", "query_avg_degree", "compare"):
        assert key in c.traffic


def test_configs_are_used_and_files_distinct():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/") and len(c["reduced"]) <= 16
        json.loads((pb_manifest.ROOT / c["file"]).read_text())


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    reader = pb_manifest.load_module("metrics", metric["name"])
    assert callable(reader.read)
    kernel = getattr(reader, "ROOFLINE", None)
    if kernel:
        km = pb_manifest.load_module("rooflines", kernel)
        assert km.KERNEL and km.OPS and callable(km.keep) and callable(km.work)


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_in_every_cell_listing_it(metric):
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", CELLS):
        assert metric["moves"] in {m["name"] for m in pb_manifest.cell(cell).end_to_end}


@pytest.mark.parametrize("cell", CELLS)
def test_layers_of_one_name_agree(cell):
    layers: dict = {}
    for m in pb_manifest.cell(cell).per_layer:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(len(set(v)) == len(v) for v in layers.values())


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        pb_manifest.cell("no.such.cell")
