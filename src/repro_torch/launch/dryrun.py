"""Dry-run planner: every (arch × shape × mesh) cell traced on a mesh the
machine does not have.

The counterpart of ``src/repro/launch/dryrun.py``, which lowers and
compiles each cell over 512 placeholder XLA devices.  Here a cell runs in
a process that stands for one rank of a 256- or 512-rank group (the fake
process group of ``torch.testing._internal.distributed.fake_pg``): its
parameters, optimizer state, cache and batch are meta tensors laid out as
DTensors by the sharding rules over the production mesh, and the train,
prefill or decode step runs on them under a
:class:`~repro_torch.roofline.analyze.Counter`.  Meta tensors hold no
storage, so the 398 B configurations plan on a laptop; "lower" and
"compile" have no counterpart.  Every figure is rank 0's, a prediction for
a mesh of H100s that this run never touches.

DTensor dispatches each op in Python, so a step at full depth and with
every microbatch would take hours on a CPU.  A cell is traced at 1 and 2
periods of its layer pattern (with its prefix layers) and, for training,
at 2 and 3 microbatches of the policy's microbatch rows, and its counts
are extrapolated bilinearly to the full depth and microbatch count: each
period and each microbatch repeats the same ops, so this is exact (the
counterpart of the reference's trip-count scaling of scanned bodies;
``tests/test_torch_dryrun.py`` holds a traced count against a longer
trace).  The arguments' bytes are those of the full cell, and the live
bytes' peak is extrapolated over depth only (microbatches run one after
another).  A first, discarded trace absorbs DTensor's one-time work for
new ops.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape train_4k --mesh single [--policy '{"microbatches": 4}']

``main`` runs each cell in its own process (a fake group cannot change
its size), with ``--skip-existing`` resuming an interrupted sweep.  A
record (``results/dryrun_torch/<arch>__<shape>__<mesh>.json``) keeps the
reference's keys where they mean the same thing:

* ``memory_analysis.argument_size_in_bytes``: the local shards of the
  step's arguments (parameters, optimizer state, cache, batch);
* ``memory_analysis.temp_size_in_bytes``: the peak of the live bytes over
  the step above the arguments;
* ``cost_analysis`` (``flops``, ``bytes accessed``, ``transcendentals``)
  and ``dispatch_walk`` (the counter's full result, in the place of the
  reference's ``hlo_walk``, with DTensor's ``CommDebugMode`` counts of
  each collective);
* ``roofline``, ``model_flops_total``/``_per_device`` and
  ``useful_flops_ratio``.

``compile_s`` and ``hlo_text_bytes`` have no counterpart and are left out;
``trace_s`` is the seconds the traced step took.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

import torch

from ..configs import SHAPES, applicable, get_config, list_archs
from ..distributed.sharding import (NamedSharding, PartitionSpec,
                                    batch_specs, cache_specs, dp_axes,
                                    distribute_tree, dp_size, param_specs)
from ..models.pspec import mesh_scope
from ..train.trainer import TrainPolicy, default_policy
from .mesh import PRODUCTION_SHAPES
from .specs import (abstract_cache, abstract_opt_state, abstract_params,
                    input_specs, sharded_config)

__all__ = ["RESULTS_DIR", "build_cell", "argument_bytes", "run_cell",
           "main", "fake_group"]

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results"
               / "dryrun_torch")

RESID_BUDGET = 4 << 30  # per-device budget for the saved residual stream

# per-arch baseline policy tweaks where the generic heuristic undershoots
# (the reference's, set against its 16 GiB budget)
ARCH_POLICY = {
    "phi3.5-moe-42b-a6.6b": {"microbatches": 16},
    "qwen2-vl-7b": {"microbatches": 8},
}


def _policy_for(cfg, shape, mesh, overrides: dict) -> TrainPolicy:
    """The reference's microbatch heuristic: the residual stream saved for
    the recomputed backward (``L_periods · B_dev · S · d · 2`` bytes) under
    :data:`RESID_BUDGET` (scaled down for multi-slot periods), and the MoE
    sort dispatch's ``(T·k, d)`` float32 permutation under 2 GiB a
    microbatch."""
    policy = default_policy(cfg)
    b_dev = max(1, shape.global_batch // dp_size(mesh))
    resid = cfg.num_periods * b_dev * shape.seq_len * cfg.d_model * 2
    budget = RESID_BUDGET // max(1, cfg.period // 2)
    moe_term = (b_dev * shape.seq_len * cfg.experts_per_token * cfg.d_model
                * 8 if cfg.uses_moe else 0)
    mb = 1
    while (resid / mb > budget or moe_term / mb > (2 << 30)) and mb < b_dev:
        mb *= 2
    mb = max(mb, ARCH_POLICY.get(cfg.name, {}).get("microbatches", 1))
    if mb > 1:
        policy = dataclasses.replace(policy, microbatches=min(mb, b_dev))
    if overrides:
        fields = {f.name for f in dataclasses.fields(TrainPolicy)}
        policy = dataclasses.replace(policy, **{
            k: v for k, v in overrides.items() if k in fields})
    return policy


def _grad_leaves(tree):
    from ..train.tree import tree_leaves

    for t in tree_leaves(tree):
        if t.is_floating_point():
            t.requires_grad_(True)
    return tree


def build_cell(cfg, shape, mesh, overrides=None, dtype=torch.bfloat16):
    """``(step, args)`` for one cell: ``step(*args)`` runs it once on the
    cell's meta DTensors over ``mesh`` (parameters in ``dtype``, bf16 as
    the reference plans them)."""
    from ..models import decode_step, prefill
    from ..train.optimizer import make_optimizer
    from ..train.trainer import make_train_step

    overrides = overrides or {}
    fw_kw = {k: overrides[k]
             for k in ("q_chunk", "kv_chunk", "moe_dispatch") if k in overrides}
    fsdp = overrides.get("fsdp", True)

    def params_on_mesh(grad: bool):
        params = abstract_params(cfg, dtype)
        if grad:
            _grad_leaves(params)
        return distribute_tree(params, mesh,
                               param_specs(params, cfg, fsdp=fsdp))

    if shape.kind == "train":
        policy = _policy_for(cfg, shape, mesh, overrides)
        policy = dataclasses.replace(policy, logits_sharding=NamedSharding(
            mesh, PartitionSpec(dp_axes(mesh), None, "model")))
        opt = make_optimizer(policy.optimizer)
        params = params_on_mesh(True)
        opt_plain = abstract_opt_state(opt, abstract_params(cfg, dtype))
        opt_state = distribute_tree(opt_plain, mesh,
                                    param_specs(opt_plain, cfg, fsdp=fsdp))
        # the update reads the step counter as a Python int: a CPU scalar
        opt_state["step"] = torch.zeros((), dtype=torch.int32)
        batch = input_specs(cfg, shape, with_labels=True)
        batch = distribute_tree(batch, mesh, batch_specs(batch, mesh))
        return make_train_step(cfg, opt, policy), (params, opt_state, batch)
    if shape.kind == "prefill":
        params = params_on_mesh(False)
        batch = input_specs(cfg, shape, with_labels=False)
        batch = distribute_tree(batch, mesh, batch_specs(batch, mesh))
        # prefill re-reads K/V once a query block: 2048-wide blocks, as
        # the reference's dry-run sets them
        fw_kw.setdefault("q_chunk", 2048)
        fw_kw.setdefault("kv_chunk", 2048)

        @torch.no_grad()
        def prefill_step(params, batch):
            return prefill(params, cfg, batch, **fw_kw)
        return prefill_step, (params, batch)
    params = params_on_mesh(False)
    cache = abstract_cache(cfg, shape.global_batch, shape.seq_len, dtype)
    cache = distribute_tree(cache, mesh, cache_specs(cache, cfg, mesh))
    batch = input_specs(cfg, shape, with_labels=False)
    batch = distribute_tree(batch, mesh, batch_specs(batch, mesh))

    @torch.no_grad()
    def serve_step(params, cache, batch):
        return decode_step(params, cfg, cache, batch)
    return serve_step, (params, cache, batch)


@contextlib.contextmanager
def fake_group(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (collectives return at once), torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _cell_path(out_dir, arch, shape_name, mesh_kind, tag):
    suffix = f"__{tag}" if tag else ""
    return pathlib.Path(out_dir) / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"


def argument_bytes(args) -> list:
    """Each tensor argument's bytes on this rank (a DTensor's local
    shard), in ``train.tree``'s leaf order."""
    from ..distributed.sharding import is_dtensor
    from ..train.tree import tree_leaves

    out = []
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if is_dtensor(t) else t
            out.append(local.numel() * local.element_size())
    return out


def _depth(cfg, periods: int):
    """``cfg`` cut to its prefix and ``periods`` periods."""
    return dataclasses.replace(
        cfg, num_layers=len(cfg.prefix) + periods * cfg.period)


def _trace(cfg, shape, mesh, overrides):
    """One traced step of a cell: the counter's result, with the live
    bytes' peak over the arguments and DTensor's collective counts."""
    from torch.distributed.tensor.debug import CommDebugMode

    from ..roofline.analyze import Counter

    step, args = build_cell(cfg, shape, mesh, overrides)
    with mesh_scope(mesh), CommDebugMode() as comm, Counter() as counter:
        counter.hold(args)
        t0 = time.perf_counter()
        step(*args)
        seconds = time.perf_counter() - t0
    del step, args
    walk = counter.result()
    walk["collective_ops"] = counter.collective_ops
    walk["comm_counts"] = {str(k): int(v)
                           for k, v in comm.get_comm_counts().items()}
    walk["temp_bytes"] = counter.peak_bytes - counter.held_bytes
    return walk, seconds


def _bilinear(vals, P: int, M: int) -> float:
    """``f(P, M)`` through ``vals = {(p, m): f}`` traced at one or two
    depths and one or two microbatch counts: exact where every period and
    every microbatch repeats the same ops, as the port's Python loops do
    (the counterpart of the reference's trip-count scaling)."""
    ps = sorted({p for p, _ in vals})
    ms = sorted({m for _, m in vals})
    p1, m1 = ps[0], ms[0]
    out = vals[(p1, m1)]
    if len(ps) > 1:
        out += (P - p1) * (vals[(ps[1], m1)] - vals[(p1, m1)])
    if len(ms) > 1:
        out += (M - m1) * (vals[(p1, ms[1])] - vals[(p1, m1)])
    if len(ps) > 1 and len(ms) > 1:
        out += (P - p1) * (M - m1) * (vals[(ps[1], ms[1])]
                                      - vals[(ps[1], m1)]
                                      - vals[(p1, ms[1])] + vals[(p1, m1)])
    return out


def _extrapolate(corners, P: int, M: int):
    """The full cell's walk from the traced corners ``{(p, m): walk}``."""
    first = next(iter(corners.values()))
    walk = {k: _bilinear({c: w[k] for c, w in corners.items()}, P, M)
            for k, v in first.items() if not isinstance(v, dict)}
    names = sorted(set().union(*(w["comm_counts"] for w in
                                 corners.values())))
    walk["comm_counts"] = {
        k: int(round(_bilinear({c: w["comm_counts"].get(k, 0)
                                for c, w in corners.items()}, P, M)))
        for k in names}
    walk["collective_ops"] = int(round(walk["collective_ops"]))
    # microbatches run one after another: the peak is one microbatch's,
    # extrapolated over depth only
    m1 = min(m for _, m in corners)
    walk["temp_bytes"] = _bilinear(
        {(p, 1): w["temp_bytes"] for (p, m), w in corners.items()
         if m == m1}, P, 1)
    return walk


def _traced_cells(cfg, shape, policy_mb: int):
    """The (periods, microbatches) at which a cell is traced: depths 1 and
    2 where the model has more periods, microbatch counts 2 and 3 where
    the policy takes more (2, not 1: one microbatch skips the gradient
    sums), the policy's own otherwise."""
    P = cfg.num_periods
    depths = (1, 2) if P > 2 else (P,)
    mbs = ((2, 3) if policy_mb > 3 else (policy_mb,)) \
        if shape.kind == "train" else (1,)
    return [(p, m) for p in depths for m in mbs]


def run_cell(arch: str, shape_name: str, mesh_kind: str, overrides=None,
             out_dir: pathlib.Path = RESULTS_DIR, tag: str = ""):
    """Trace one cell under a fake group of the production mesh's size and
    write its record; returns the record."""
    from ..roofline.analyze import roofline_terms
    from ..roofline.model_flops import model_flops
    from .mesh import make_production_mesh

    cfg = sharded_config(get_config(arch))
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    multi = mesh_kind == "multi"
    dims, _ = PRODUCTION_SHAPES[multi]
    n_dev = math.prod(dims)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "mesh_shape": list(dims), "overrides": overrides or {},
              # DTensor's strategies, and with them the figures, change
              # between torch versions
              "torch_version": torch.__version__, "status": "running"}
    try:
        with fake_group(n_dev):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            # the arguments at full depth: their local shards, exactly
            args_bytes = sum(argument_bytes(
                build_cell(cfg, shape, mesh, overrides)[1]))
            M = (_policy_for(cfg, shape, mesh, overrides or {}).microbatches
                 if shape.kind == "train" else 1)
            rows = shape.global_batch // M
            corners, seconds = {}, 0.0
            cells = _traced_cells(cfg, shape, M)
            # the first trace of a process also runs DTensor's one-time
            # work a new op needs (a few local ops); a warm-up keeps it out
            for p, m in cells[:1] + cells:
                cut = dataclasses.replace(shape, global_batch=rows * m)
                ov = dict(overrides or {}, microbatches=m) \
                    if shape.kind == "train" else overrides
                corners[(p, m)], dt = _trace(_depth(cfg, p), cut, mesh, ov)
                seconds += dt
        walk = _extrapolate(corners, cfg.num_periods, M)
        record["traced"] = {"periods_microbatches": sorted(corners),
                            "scaled_to": [cfg.num_periods, M],
                            "trace_s": round(seconds, 2)}
        record["memory_analysis"] = {
            "argument_size_in_bytes": args_bytes,
            "temp_size_in_bytes": int(walk.pop("temp_bytes"))}
        record["cost_analysis"] = {"flops": walk["flops"],
                                   "bytes accessed": walk["bytes"],
                                   "transcendentals": walk["transcendentals"]}
        record["dispatch_walk"] = walk
        record["roofline"] = roofline_terms(walk["flops"], walk["bytes"],
                                            walk["collective_bytes"])
        mf = model_flops(cfg, shape)
        record["model_flops_total"] = mf
        record["model_flops_per_device"] = mf / n_dev
        # model flops over counted flops: < 1 is recomputation, dispatch
        # work and padding; > 1 would be compute the counter missed
        record["useful_flops_ratio"] = ((mf / n_dev) / walk["flops"]
                                        if walk["flops"] else None)
        record["status"] = "ok"
    except Exception as e:  # a cell's failure is its record, not the sweep's
        record["status"] = "error"
        record["error"] = repr(e)
        record["traceback"] = traceback.format_exc()[-4000:]
    path = _cell_path(out_dir, arch, shape_name, mesh_kind, tag)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1))
    ma = record.get("memory_analysis", {})
    print(f"[{arch} × {shape_name} × {mesh_kind}] -> {record['status']} "
          f"(traced {record.get('traced', {}).get('trace_s', '-')} s, args "
          f"{ma.get('argument_size_in_bytes', 0) / 2**30:.2f} GiB, temp "
          f"{ma.get('temp_size_in_bytes', 0) / 2**30:.2f} GiB / device)",
          flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--policy", default=None, help="JSON overrides")
    ap.add_argument("--tag", default="", help="suffix for result files")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--in-process", action="store_true",
                    help=argparse.SUPPRESS)  # one cell, this process
    args = ap.parse_args(argv)

    overrides = json.loads(args.policy) if args.policy else None
    out_dir = pathlib.Path(args.out)
    if args.in_process:
        rec = run_cell(args.arch, args.shape, args.mesh, overrides, out_dir,
                       args.tag)
        raise SystemExit(0 if rec["status"] != "error" else 1)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in meshes:
                path = _cell_path(out_dir, arch, shape_name, mesh_kind,
                                  args.tag)
                if args.skip_existing and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[{arch} × {shape_name} × {mesh_kind}] "
                              f"cached ({prev['status']})")
                        continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--in-process", "--arch", arch, "--shape", shape_name,
                       "--mesh", mesh_kind, "--out", str(out_dir),
                       "--tag", args.tag]
                if args.policy:
                    cmd += ["--policy", args.policy]
                if subprocess.run(cmd).returncode != 0:
                    failures += 1
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")
    print("dry-run complete: all cells ok")


if __name__ == "__main__":
    main()
