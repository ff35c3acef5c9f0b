"""Find a cell's configuration, traffic mix and metrics by name.

``BENCHMARK.json`` at the checkout's root names each cell's
configuration and mix; the files are ``portbench/configs/<config>.json``
and ``portbench/traffic/<mix>.json``; each per-layer metric's reader is
``portbench/metrics/<metric>.py`` and each kernel's work count
``portbench/rooflines/<kernel>.py``.  A later cell, mix, metric or
kernel is added as files and entries, never by editing these.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

__all__ = ["HERE", "ROOT", "Cell", "load_manifest", "cell", "load_module", "NAME", "UNIT"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # the manifest's entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest, its files read."""
    m = load_manifest(root)
    found = [w for w in m["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    if not (NAME.match(w["config"]) and NAME.match(w["traffic"])):
        raise ValueError(f"bad config or traffic name in {name!r}")
    conf = [c for c in m["configs"] if c["name"] == w["config"]][0]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [x for x in m["end_to_end"] if name in x.get("workloads", [name])]
    names = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"]
                 if (name in x["workloads"] if "workloads" in x else x["moves"] in names)]
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer)


def load_module(kind: str, name: str, root: Path = ROOT):
    """``portbench/<kind>/<name>.py`` as a module (kind: metrics, rooflines)."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / "portbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
