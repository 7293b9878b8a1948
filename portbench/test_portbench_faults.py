"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell on the CPU at the tiny size, with
the harness's look for a card skipped and the card's path taken, as it is
on the cards at SF10: forced (``policy="tensor"``) on one device, where at
this size ``auto`` would answer on the host; over the eight lanes of a
sharded cell by the path selector's decision set to them, since ``auto``
prices the lanes by the CPU's own measured times, which other test
processes sway (``tensor`` decides one device).  Each plants one fault of
those the cell can have in the engine: an answer altered where it is
produced, half of the probe rows left out of the join, and, where the
cell spans cards, the exchange between them left out."""
import dataclasses

import pytest

from portbench import tiny
from repro_torch.core import fused
from repro_torch.core.path_selector import PathSelector

CELLS = tiny.CELLS
SHARDED = tiny.SHARDED


@pytest.fixture(autouse=True)
def lanes(monkeypatch):
    """Every fragment of a sharded session decided onto its lanes."""
    choose = PathSelector.choose_fragment

    def on_lanes(self, *args, max_shards: int = 1, **kw):
        d = choose(self, *args, max_shards=max_shards, **kw)
        if max_shards > 1:
            d = dataclasses.replace(d, path="tensor", shards=max_shards,
                                    tiered=False)
        return d

    monkeypatch.setattr(PathSelector, "choose_fragment", on_lanes)


def _run(cell):
    if cell in SHARDED:
        result, info, checks = tiny.run(cell)
        assert set(info["paths"]) == {"tensor/8"}, info["paths"]
    else:
        result, info, checks = tiny.run(cell, policy="tensor")
        assert set(info["paths"]) == {"tensor/1"}, info["paths"]
    return result, checks


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, checks = _run(cell)
    assert result["correct"] is True, checks


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_caught(cell, monkeypatch):
    fetch = fused._fetch

    def altered(out):
        got = fetch(out)
        if "scalar" in got:
            got["scalar"] = got["scalar"] + 1
        if "l_extendedprice" in got.get("cols", {}):
            got["cols"]["l_extendedprice"] = got["cols"]["l_extendedprice"] + 1
        return got

    monkeypatch.setattr(fused, "_fetch", altered)
    result, checks = _run(cell)
    assert result["correct"] is False
    assert any(v["value"] > 0 for k, v in checks.items()
               if k.endswith(("_abs_err", "_rows_wrong"))), checks


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_probe_rows_left_out_is_caught(cell, monkeypatch):
    for name in ("_join_dense", "_join_sorted", "_join_sorted_run"):
        core = getattr(fused, name)

        def halved(*args, _core=core, _name=name, **kw):
            args = list(args)
            i = 2 if _name == "_join_sorted_run" else 3   # n_probe
            args[i] = args[i] // 2
            return _core(*args, **kw)

        monkeypatch.setattr(fused, name, halved)
    result, checks = _run(cell)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("cell", SHARDED)
def test_exchange_between_cards_left_out_is_caught(cell, monkeypatch):
    combine = dict(fused._COMBINE)
    combine["sum"] = lambda partials: partials[0]   # the first card's only
    monkeypatch.setattr(fused, "_COMBINE", combine)
    result, checks = _run(cell)
    assert result["correct"] is False
    assert checks["qa_abs_err"]["value"] > 0, checks
