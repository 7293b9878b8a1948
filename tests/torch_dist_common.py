"""Multi-process helpers of the port's mesh tests: ``run_ranks`` starts
``world`` processes (``spawn``), each a rank of a gloo (or NCCL) process
group that meets through a file in a fresh temporary directory (no TCP
port, which another run on the same machine could take first), runs one
worker of this module in each and waits with a time limit.  The workers
import torch and ``repro_torch`` only (never JAX), and rank 0 writes its
result as JSON to the path it is given.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, rdzv, backend, worker, out, args):
    torch.set_num_threads(1)
    kw = {}
    if backend == "nccl":   # one card a rank
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=f"file://{rdzv}",
                            rank=rank, world_size=world, **kw)
    try:
        result = worker(rank, world, *args)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(worker, world: int, out: str, *args, timeout: float = 300.0,
              backend: str = "gloo"):
    """``worker(rank, world, *args)`` on ``world`` ranks of a ``backend``
    group (``"nccl"``: rank r on card r); rank 0's return value, read back
    from ``out``.  Raises if a rank fails or the ranks outlive ``timeout``
    seconds (they are then terminated)."""
    tmp = tempfile.mkdtemp(prefix="rdzv")
    ctx = mp.start_processes(_entry, args=(world, os.path.join(tmp, "store"),
                                           backend, worker, out, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
    with open(out) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def constrain_worker(rank, world):
    """On a (1, 2) mesh: ``constrain`` lays a DTensor out by logical names
    (the values unchanged), leaves a dimension that does not divide
    replicated, and hands a leaf its gradient in its own layout; outside
    the mesh scope it returns its input."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.pspec import ambient_mesh, constrain

    mesh = make_local_mesh(1, 2, device_type="cpu")
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    out = {"outside_is_input": constrain(d, "dp", None, "model") is d,
           "ambient_outside": ambient_mesh() is None}
    with mesh:
        out["ambient_inside"] = ambient_mesh() is mesh
        c = constrain(d, "dp", None, "model")
        out["placements"] = [str(p) for p in c.placements]
        out["local_shape"] = list(c.to_local().shape)
        out["values_equal"] = bool(torch.equal(c.full_tensor(), x))
        # 3 does not divide over 2: left replicated
        out["odd_placements"] = [str(p) for p in
                                 constrain(d, None, "model", None).placements]
        w = distribute_tensor(x.clone(), mesh, [Replicate(), Replicate()])
        w.requires_grad_(True)
        (constrain(w, None, None, "model") * 3.0).sum().backward()
        out["leaf_grad_placements"] = [str(p) for p in w.grad.placements]
        out["grad_equal"] = bool(torch.equal(w.grad.full_tensor(),
                                             torch.full_like(x, 3.0)))
    out["plain_is_input"] = constrain(x, "dp", None, "model") is x
    return out


def _err(a, b) -> float:
    """Largest difference, relative to ``b``'s largest magnitude."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def kernel_wrappers_worker(rank, world, device="cpu", data=2):
    """On a (data, world / data) mesh: the hand kernels' wrappers with
    DTensor inputs against the same calls on plain tensors, values and
    gradients: flash attention at four GQA groupings, the MoE layer body,
    and the single MoE ops.  On ``device="cpu"`` the shards take the plain
    versions; on ``"cuda"`` (an NCCL group, a card a rank) the local calls
    launch the kernels, and the launches made by rank 0's DTensor calls
    are counted.  Every rank makes the same inputs from the same seed and
    takes its own shards of them (no scatter)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import distribute_tensor as _distribute

    from repro_torch.device import launch_counts
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.pspec import mesh_scope

    mesh = make_local_mesh(data, world // data, device_type=device)
    rep = [Replicate(), Replicate()]

    def distribute_tensor(t, mesh, placements):
        return _distribute(t, mesh, placements, src_data_rank=None)

    g = torch.Generator().manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, generator=g).to(device)
    launched = {}

    def counted(fn, *args, **kw):
        before = launch_counts()
        out = fn(*args, **kw)
        for n, c in launch_counts().items():
            launched[n] = launched.get(n, 0) + c - before.get(n, 0)
        return out

    out = {}
    with mesh_scope(mesh):
        for H, KH in ((4, 2), (4, 1), (6, 3), (4, 4)):
            q, k, v = randn(2, 8, H, 16), randn(2, 8, KH, 16), \
                randn(2, 8, KH, 8)
            want = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ref = flash_attention(*want, q_blk=4, kv_blk=4)
            ref.square().sum().backward()
            ds = [distribute_tensor(t, mesh, [Shard(0), Replicate()])
                  .requires_grad_(True) for t in (q, k, v)]
            got = counted(flash_attention, *ds, q_blk=4, kv_blk=4)
            counted(got.square().sum().backward)
            out[f"attn_{H}_{KH}"] = {
                "placements": [str(p) for p in got.placements],
                "err": _err(got.full_tensor(), ref),
                "grad_err": max(_err(d.grad.full_tensor(), w.grad)
                                for d, w in zip(ds, want))}

        class Cfg:
            num_experts, experts_per_token = 4, 2

        T, d, C = 16, 8, 8
        x = randn(T, d)
        idx = torch.stack([torch.randperm(4, generator=g)[:2]
                           for _ in range(T)]).to(device)
        w = torch.rand(T, 2, generator=g).to(device)
        params = {n: randn(4, d if n != "wo" else 6, 6 if n != "wo" else d)
                  for n in ("wg", "wi", "wo")}

        def ffn(p, buf, cfg):
            h = torch.nn.functional.silu(
                torch.einsum("ecd,edf->ecf", buf, p["wg"])) * \
                torch.einsum("ecd,edf->ecf", buf, p["wi"])
            return torch.einsum("ecf,efd->ecd", h, p["wo"])

        plain = {n: t.clone().requires_grad_(True) for n, t in params.items()}
        xw = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
        ref = moe_ops.moe_dispatch(plain, xw[0], idx, xw[1], Cfg, C, ffn)
        ref.square().sum().backward()
        dp = {n: distribute_tensor(t, mesh, [Replicate(), Shard(0)])
              .requires_grad_(True) for n, t in params.items()}
        dx = distribute_tensor(x, mesh, [Shard(0), Replicate()]) \
            .requires_grad_(True)
        dw = distribute_tensor(w, mesh, [Shard(0), Replicate()]) \
            .requires_grad_(True)
        di = distribute_tensor(idx, mesh, [Shard(0), Replicate()])
        got = counted(moe_ops.moe_dispatch, dp, dx, di, dw, Cfg, C, ffn)
        counted(got.square().sum().backward)
        out["moe_layer"] = {
            "err": _err(got.full_tensor(), ref),
            "grad_err": max([_err(dx.grad.full_tensor(), xw[0].grad),
                             _err(dw.grad.full_tensor(), xw[1].grad)]
                            + [_err(dp[n].grad.full_tensor(), plain[n].grad)
                               for n in params])}
        slot = moe_ops.expert_slots(idx, 4)
        r = lambda t: distribute_tensor(t, mesh, rep)
        buf = moe_ops.dispatch(x, idx[:, 0], slot[:, 0], 4, C)
        out["single_ops"] = {
            "expert_slots": bool(torch.equal(
                moe_ops.expert_slots(di, 4).full_tensor(), slot)),
            "dispatch": _err(moe_ops.dispatch(
                r(x), r(idx[:, 0]), r(slot[:, 0]), 4, C).full_tensor(), buf),
            "combine_slots": _err(moe_ops.combine_slots(
                r(buf), r(idx), r(slot), r(w)).full_tensor(),
                moe_ops.combine_slots(buf, idx, slot, w))}
    out["launched"] = launched
    return out


def sharded_train_worker(rank, world, params_path, batch_path, steps):
    """The port's ``make_train_step`` on a (2, 4) mesh: the Phi-3.5-MoE
    smoke config (``vocab_pad_multiple=8``), AdamW lr 1e-2, recomputation,
    2 microbatches, the parameters and AdamW state laid out by
    ``param_specs`` and the batch by ``batch_specs``; the losses, and
    whether every parameter got a gradient."""
    import dataclasses
    import pickle

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  PartitionSpec, batch_specs,
                                                  distribute_tree,
                                                  param_specs)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.interop import params_from_numpy
    from repro_torch.models.pspec import mesh_scope
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.trainer import TrainPolicy, make_train_step
    from repro_torch.train.tree import tree_leaves

    mesh = make_local_mesh(2, 4, device_type="cpu")
    cfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                              vocab_pad_multiple=8)
    with open(params_path, "rb") as f:
        params = params_from_numpy(pickle.load(f), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in np.load(batch_path).items()}
    opt = make_optimizer("adamw", lr=1e-2)
    policy = TrainPolicy(remat=True, microbatches=2,
                         logits_sharding=NamedSharding(
                             mesh, PartitionSpec(("data",), None, "model")))
    step = make_train_step(cfg, opt, policy)
    state = opt.init(params)
    params = distribute_tree(params, mesh, param_specs(params, cfg))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = distribute_tree(state, mesh, param_specs(state, cfg))
    batch = distribute_tree(batch, mesh, batch_specs(batch, mesh))
    losses = []
    with mesh_scope(mesh):
        for _ in range(steps):
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"].full_tensor()))
    return {"losses": losses,
            "all_grads": all(p.grad is not None for p in tree_leaves(params)),
            "sharded_leaves": sum(
                any(not pl.is_replicate() for pl in p.placements)
                for p in tree_leaves(params))}


def finite(values) -> bool:
    return all(math.isfinite(v) for v in values)
