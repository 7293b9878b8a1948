#!/usr/bin/env python3
"""The benchmark of ``repro_torch`` on NVIDIA cards: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The run makes its tables from the seed,
sets up the engine over them, warms up, measures for ``--seconds`` and
prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit, which also
close its standard error.  The line before the last holds the set-up's
steps, the bytes spilled and what the trace counted.

Without a CUDA card, with fewer cards than the cell asks for, without the
engine's sources in the checkout, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits non-zero.  The
kernels build into ``build/`` inside the checkout, at fixed paths, so only
the first run in a checkout builds them.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fail(msg: str, code: int = 1) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def power_limit() -> str:
    """The first card's name and power limit as ``nvidia-smi`` gives them,
    or "not measured"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else \
        "not measured"


def cache_dirs() -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if args.seconds <= 0:
        fail("--seconds must be positive", 2)

    sys.path.insert(0, str(ROOT))
    from portbench import harness

    bench = harness.benchmark(ROOT)
    try:
        cell, entry = harness.cell_of(bench, args.workload)
    except KeyError as exc:
        fail(str(exc.args[0]), 2)
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} are present")
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"the engine's sources are not in this checkout ({src})")
    cache_dirs()
    sys.path.insert(0, str(src))
    import repro_torch

    if Path(repro_torch.__file__).resolve().parents[1] != src.resolve():
        fail(f"repro_torch was loaded from {repro_torch.__file__}, not from "
             f"this checkout")
    result, info, checks = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), T_START,
        bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        fail(f"modules loaded that the benchmark may not load: {bad}")
    info["setup"]["torch_import_s"] = t_torch - T_START
    # read once the window has closed: nvidia-smi is no part of set-up
    info["card"] = power_limit()
    print(json.dumps(info), flush=True)
    print(json.dumps(result, default=float), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
