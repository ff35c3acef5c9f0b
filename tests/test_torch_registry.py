"""``repro_torch.configs``' registry against the JAX package's: every
architecture of ``repro.configs.list_archs(include_extra=True)`` resolves
with the reference's name, family, source, notes and shape cells; its
config equals the reference's field by field (smoke and published, also
under ``REPRO_OVERRIDES``); ``all_cells`` names the same pairs; and the
training launcher picks its default cell as the reference's does."""
import dataclasses

import pytest

from repro import configs as jcfg
from repro_torch import configs as tcfg

NAMES = jcfg.list_archs(include_extra=True)
# fields of the reference's RecsysConfig the port does not carry, and the
# only value the port implements for each
PORT_FIXED = {"multi_hot": 1, "dtype": "float32"}
OVERRIDES = ("d_hidden=32,n_layers=3,partition_parallel=true,cutoff=5.5,aggregator=sum,"
             "remat=false,loss_chunk=64,n_queries=7,label_hash=yes,m=3,embed_dim=4,"
             "no_such_field=1")


def _fields_equal(tc, jc):
    want = dataclasses.asdict(jc)
    got = dataclasses.asdict(tc)
    for k, v in want.items():
        if k not in got:
            assert PORT_FIXED.get(k, object()) == v, k
            continue
        assert got[k] == v, k
    assert set(got) <= set(want)


def test_list_archs_equal_the_reference():
    assert tcfg.list_archs() == jcfg.list_archs()
    assert tcfg.list_archs(include_extra=True) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_get_arch_fields_equal_the_reference(name):
    ta, ja = tcfg.get_arch(name), jcfg.get_arch(name)
    assert (ta.name, ta.family, ta.source, ta.notes) == (ja.name, ja.family, ja.source, ja.notes)
    assert [(c.name, c.kind, c.meta, c.skip) for c in ta.shapes] == [
        (c.name, c.kind, c.meta, c.skip) for c in ja.shapes]


@pytest.mark.parametrize("name", NAMES)
def test_resolve_config_equal_field_by_field(name, monkeypatch):
    ta, ja = tcfg.get_arch(name), jcfg.get_arch(name)
    for env in ("", OVERRIDES):
        monkeypatch.setenv("REPRO_OVERRIDES", env)
        for smoke in (True, False):
            for tcell, jcell in zip(ta.shapes, ja.shapes):
                tc = tcfg.resolve_config(ta, tcell, smoke=smoke)
                _fields_equal(tc, jcfg.resolve_config(ja, jcell, smoke=smoke))
                if env and hasattr(tc, "n_queries"):
                    assert tc.n_queries == 7 and tc.label_hash


@pytest.mark.parametrize("skipped", [False, True])
@pytest.mark.parametrize("extra", [False, True])
def test_all_cells_name_the_same_pairs(skipped, extra):
    def names(cells):
        return [(a.name, c.name) for a, c in cells]

    got = tcfg.all_cells(include_skipped=skipped, include_extra=extra)
    assert names(got) == names(jcfg.all_cells(include_skipped=skipped, include_extra=extra))
    assert all(isinstance(a, tcfg.ArchDef) for a, _ in got)


def test_arch_def_carries_the_reference_notes():
    assert tcfg.get_arch("mace").notes == jcfg.get_arch("mace").notes != ""


def test_every_kind_builds_a_step():
    for arch, cell in tcfg.all_cells(include_skipped=True, include_extra=True):
        cfg = tcfg.resolve_config(arch, cell, smoke=True)
        step, takes_opt = tcfg.build_step(arch, cell, cfg)
        assert callable(step) and takes_opt == (cell.kind not in (
            "prefill", "decode", "serve", "retrieval", "gnnpe_online")), (arch.name, cell.name)


@pytest.mark.parametrize("name,cell", [("gnn-pe-offline", "offline_pairs"),
                                       ("gin-tu", "full_graph_sm")])
def test_launcher_default_cell_is_the_first_shape(name, cell, capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", name, "--steps", "3", "--device", "cpu", "--log-every", "1"])
    assert out["steps"] == 3 and out["final_loss"] == out["final_loss"]
    assert f"{name}/{cell}" in capsys.readouterr().out
