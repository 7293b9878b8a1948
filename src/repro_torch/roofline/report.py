"""The dry-run, roofline and memory tables from ``results/dryrun_torch``.
The counterpart of ``src/repro/roofline/report.py``.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir DIR]

Every figure in them is a prediction, per device of a mesh of H100s that
the dry-run only planned (``repro_torch.launch.dryrun``), not a
measurement.  Each row names the torch version that traced it: DTensor's
sharding strategies, and so the figures, differ between versions.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .hw import HBM_BYTES

__all__ = ["load", "dryrun_table", "roofline_table", "hbm_check", "main"]

DEFAULT_DIR = os.path.join("results", "dryrun_torch")

_MOVE_HINT = {
    "compute": "tensor-core-shaped products / less recomputation",
    "memory": "fuse or narrow the largest intermediates (the MoE "
              "buffers, attention's score blocks); raise arithmetic intensity",
    "collective": "re-shard to cut the dominant collective (FSDP gathers, "
                  "the MoE buffer's all-reduce); overlap with compute",
}


def load(dir_: str, mesh: str):
    return [json.loads(open(f).read())
            for f in sorted(glob.glob(os.path.join(dir_, f"*__{mesh}.json")))]


def _torch(r) -> str:
    return r.get("torch_version", "?")


def dryrun_table(dir_: str) -> str:
    out = ["| arch | shape | mesh | status | torch | traced s | args GiB | "
           "temp GiB |", "|---|---|---|---|---|---|---|---|"]
    for mesh in ("single", "multi"):
        for r in load(dir_, mesh):
            if r["status"] == "skipped":
                out.append(f"| {r['arch']} | {r['shape']} | {mesh} | SKIP "
                           f"({r['reason'][:40]}…) | | | | |")
                continue
            ma = r.get("memory_analysis", {})
            out.append(
                f"| {r['arch']} | {r['shape']} | {mesh} | {r['status']} "
                f"| {_torch(r)} "
                f"| {r.get('traced', {}).get('trace_s', '')} "
                f"| {ma.get('argument_size_in_bytes', 0) / 2**30:.2f} "
                f"| {ma.get('temp_size_in_bytes', 0) / 2**30:.2f} |")
    return "\n".join(out)


def roofline_table(dir_: str) -> str:
    out = ["| arch | shape | torch | t_compute s | t_memory s | t_coll s "
           "| dominant | roofline frac | MODEL_FLOPS/dev | useful ratio "
           "| lever |", "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in load(dir_, "single"):
        if r["status"] != "ok":
            continue
        rl = r.get("roofline", {})
        dom = rl.get("dominant", "?")
        out.append(
            f"| {r['arch']} | {r['shape']} | {_torch(r)} "
            f"| {rl.get('t_compute_s', 0):.4f} | {rl.get('t_memory_s', 0):.4f} "
            f"| {rl.get('t_collective_s', 0):.4f} | {dom} "
            f"| {rl.get('roofline_fraction', 0):.3f} "
            f"| {r.get('model_flops_per_device', 0):.2e} "
            f"| {r.get('useful_flops_ratio') or 0:.2f} "
            f"| {_MOVE_HINT.get(dom, '')} |")
    return "\n".join(out)


def hbm_check(dir_: str) -> str:
    cap = HBM_BYTES / 2**30
    out = [f"| arch | shape | mesh | torch | args+temp GiB | fits "
           f"{cap:.1f} GiB (H100) |", "|---|---|---|---|---|---|"]
    for mesh in ("single", "multi"):
        for r in load(dir_, mesh):
            if r["status"] != "ok":
                continue
            ma = r.get("memory_analysis", {})
            tot = (ma.get("argument_size_in_bytes", 0)
                   + ma.get("temp_size_in_bytes", 0))
            fits = "yes" if tot <= HBM_BYTES else "**no**"
            out.append(f"| {r['arch']} | {r['shape']} | {mesh} "
                       f"| {_torch(r)} | {tot / 2**30:.2f} | {fits} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline", "hbm"])
    args = ap.parse_args(argv)
    if args.section in ("all", "dryrun"):
        print("### Dry-run (predictions per device)\n")
        print(dryrun_table(args.dir))
    if args.section in ("all", "roofline"):
        print("\n### Roofline (single-pod 16×16, H100 rates; predictions)\n")
        print(roofline_table(args.dir))
    if args.section in ("all", "hbm"):
        print("\n### HBM budget (predictions)\n")
        print(hbm_check(args.dir))


if __name__ == "__main__":
    main()
