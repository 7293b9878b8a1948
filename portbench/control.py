#!/usr/bin/env python3
"""The control: the upper readings that the limits of
``portbench/reference/compare.py`` are set against.

    python3 portbench/control.py --workload <cell> --seeds 4 5 6

For each seed it makes the cell's tables at the cell's size, puts the
plain reference, computed in a lower precision, in the program's place
(sums and prices in float32, the step that would tempt a faster program,
and in int32), and prints one JSON line a precision with the numbers it
gives against the exact reference.  The lower readings are the program's:
the ``checks`` of the benchmark's own runs.  Runs on the first card; the
CPU tests call :func:`control_numbers` at a tiny size.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the lower precisions the control computes in
CONTROL_DTYPES = ("float32", "int32")


def control_numbers(tables, traffic: dict, device, dtype):
    """The numbers compared when the plain reference, computed in
    ``dtype``, answers in the program's place: ``[(name, kind, value)]``.
    ``tables`` maps each table's name to its host columns."""
    from portbench import harness
    from portbench.reference import compare

    out = []
    for name in traffic["mix"]:
        ref = harness.reference_module(name)
        want = ref.answer(tables, traffic["params"], device)
        got = ref.answer(tables, traffic["params"], device, dtype=dtype)
        if isinstance(want, dict):
            out.append((f"{name}_rows_wrong", "rows_wrong",
                        compare.rows_wrong(got, want)))
        else:
            out.append((f"{name}_abs_err", "abs_err",
                        compare.scalar_err(got, want)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, run
    from portbench.reference import compare

    if not torch.cuda.is_available():
        run.fail("no CUDA card")
    bench = harness.benchmark(ROOT)
    cell, entry = harness.cell_of(bench, args.workload)
    cfg = harness.config_of(entry)
    traffic = harness.traffic_of(cell["traffic"])
    for seed in args.seeds:
        tables = harness.host_tables(harness.data_module(cfg["data"])
                                     .make_tables(cfg, seed, "cuda:0"))
        for name in CONTROL_DTYPES:
            numbers = control_numbers(tables, traffic, "cuda:0",
                                      getattr(torch, name))
            checks, ok = compare.checks(numbers)
            print(json.dumps({"reading": f"control {name}", "seed": seed,
                              "correct": ok, "checks": checks}), flush=True)
        del tables
    if harness.forbidden_modules():
        run.fail(f"forbidden modules loaded: {harness.forbidden_modules()}")


if __name__ == "__main__":
    main()
