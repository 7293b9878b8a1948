"""The port's sharded train step on 8 gloo ranks against the reference's
8-device sharded step.

The reference runs as ``tests/test_distributed_e2e.py`` runs it (a child
process with eight forced host devices, a (2, 4) ``("data", "model")``
mesh, FSDP over ``"data"``, tensor and expert parallelism over
``"model"``), and hands its initial weights and batch across.  The port
runs ``make_train_step`` unchanged on 8 gloo ranks of a (2, 4)
``make_local_mesh``, its parameters and AdamW state laid out by
``param_specs``, its batch by ``batch_specs``, and, from the same weights,
unsharded in this process.  Each loss of the 3 steps must be finite,
falling, and within 1e-4 (relative) of the reference's sharded one and of
the port's unsharded one.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import torch

from torch_dist_common import finite, run_ranks, sharded_train_worker

from repro_torch.configs import get_smoke_config
from repro_torch.models.interop import params_from_numpy
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.trainer import TrainPolicy, make_train_step
from repro_torch.train.tree import tree_leaves

STEPS = 3
RTOL = 1e-4

# the reference's test script, which also writes its initial weights and
# its batch for the port
_REFERENCE = textwrap.dedent("""
    import json, pickle, sys
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.distributed.sharding import (batch_specs, param_specs,
                                            tree_shardings)
    from repro.launch.mesh import make_local_mesh
    from repro.models import init_model
    from repro.train.optimizer import make_optimizer
    from repro.train.trainer import TrainPolicy, make_train_step

    out_dir = sys.argv[1]
    mesh = make_local_mesh(data=2, model=4)
    cfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                              vocab_pad_multiple=8)
    params = init_model(jax.random.PRNGKey(0), cfg)
    with open(out_dir + "/params.pkl", "wb") as f:
        pickle.dump(jax.device_get(params), f)
    opt = make_optimizer("adamw", lr=1e-2)
    policy = TrainPolicy(remat=True, microbatches=2,
                         logits_sharding=NamedSharding(
                             mesh, P(("data",), None, "model")))
    step = make_train_step(cfg, opt, policy)
    batch = {
        "tokens": jnp.asarray(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (8, 32)), jnp.int32),
        "labels": jnp.asarray(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (8, 32)), jnp.int32),
    }
    np.savez(out_dir + "/batch.npz",
             **{k: np.asarray(v) for k, v in batch.items()})
    p_specs = param_specs(jax.eval_shape(lambda: params), cfg)
    opt_state = opt.init(params)
    o_specs = param_specs(jax.eval_shape(lambda: opt_state), cfg)
    b_specs = batch_specs(jax.eval_shape(lambda: batch), mesh)
    with mesh:
        p_sh = tree_shardings(mesh, p_specs)
        o_sh = tree_shardings(mesh, o_specs)
        fn = jax.jit(step,
                     in_shardings=(p_sh, o_sh, tree_shardings(mesh, b_specs)),
                     out_shardings=(p_sh, o_sh, None))
        params = jax.device_put(params, p_sh)
        opt_state = jax.device_put(opt_state, o_sh)
        batch = jax.device_put(batch, tree_shardings(mesh, b_specs))
        losses = []
        for _ in range(%d):
            params, opt_state, metrics = fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
    print(json.dumps({"losses": losses, "devices": jax.device_count()}))
""" % STEPS)


def _reference(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["devices"] == 8
    return out["losses"]


def _unsharded(params_path, batch_path):
    cfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                              vocab_pad_multiple=8)
    with open(params_path, "rb") as f:
        params = params_from_numpy(pickle.load(f), device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in np.load(batch_path).items()}
    opt = make_optimizer("adamw", lr=1e-2)
    step = make_train_step(cfg, opt, TrainPolicy(remat=True, microbatches=2))
    state = opt.init(params)
    losses = []
    for _ in range(STEPS):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def _close(a, b) -> bool:
    return all(abs(x - y) <= RTOL * abs(y) for x, y in zip(a, b))


def test_sharded_train_step_on_8_ranks_matches_reference(tmp_path):
    ref = _reference(tmp_path)
    params_path, batch_path = tmp_path / "params.pkl", tmp_path / "batch.npz"
    out = run_ranks(sharded_train_worker, 8, str(tmp_path / "port.json"),
                    str(params_path), str(batch_path), STEPS, timeout=480)
    sharded = out["losses"]
    plain = _unsharded(params_path, batch_path)
    assert out["all_grads"] and out["sharded_leaves"] > 0, out
    assert finite(sharded) and sharded[-1] < sharded[0], sharded
    assert _close(sharded, ref), (sharded, ref)
    assert _close(sharded, plain), (sharded, plain)
