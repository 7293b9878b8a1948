"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell on the CPU at the tiny size, with
the harness's look for a card skipped and the card's path taken, as it is
on the cards at SF10: forced (``policy="tensor"``) on one device, where at
this size ``auto`` would answer on the host; over the eight lanes of a
sharded cell by the path selector's decision set to them, since ``auto``
prices the lanes by the CPU's own measured times, which other test
processes sway (``tensor`` decides one device).  Each plants one fault of
those the cell can have in the engine, found by name as every other part
of the harness (``portbench/faults/<fault>.py``: ``plant(monkeypatch)``):
each fault that a query of the cell's mix names in ``FAULTS`` (an answer
altered where it is produced, half of the rows of the operator that
consumes the query's largest input left out) and, where the cell spans
cards, the exchange between them left out."""
import dataclasses

import pytest

from portbench import harness, tiny
from repro_torch.core.path_selector import PathSelector

CELLS = tiny.CELLS
SHARDED = tiny.SHARDED
#: every (cell, fault) the cells' queries name
PAIRS = [(cell, fault) for cell in CELLS for fault in tiny.faults(cell)]
#: every query of the cells' mixes
QUERIES = sorted({q for cell in CELLS for q in harness.traffic_of(
    harness.cell_of(tiny.bench(), cell)[0]["traffic"])["mix"]})


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


def _wrong(checks) -> bool:
    """Whether some answer compared with the reference was wrong."""
    return any(v["value"] > 0 for k, v in checks.items()
               if k.endswith(("_abs_err", "_rows_wrong")))


@pytest.mark.parametrize("query", QUERIES)
def test_every_query_names_faults_that_are_found(query):
    names = getattr(harness.query_module(query), "FAULTS", ())
    assert names, f"{query} names no fault its answer must fail under"
    for name in names:
        assert callable(harness._load_file("faults", name).plant), name


@pytest.mark.parametrize("cell,fault", PAIRS)
def test_planted_fault_is_caught(cell, fault, monkeypatch):
    harness._load_file("faults", fault).plant(monkeypatch)
    result, checks = _run(cell)
    assert result["correct"] is False
    assert _wrong(checks), checks


@pytest.mark.parametrize("cell", SHARDED)
def test_exchange_between_cards_left_out_is_caught(cell, monkeypatch):
    harness._load_file("faults", "exchange_left_out").plant(monkeypatch)
    result, checks = _run(cell)
    assert result["correct"] is False
    assert _wrong(checks), checks
