"""Shared by ``tests/test_torch_train_{moe,dense,other}.py``: one
architecture's smoke config trained by the reference's ``make_train_step``
and by the port's on the same batch, from the same weights (the
reference's, handed across with ``params_from_numpy``), on the CPU.

Tolerances, with their reasons:
  * loss: rtol 1e-5 (both packages sum the same float32 terms in other
    orders);
  * gradients, every leaf: within ``rtol 1e-4`` of the reference's plus
    ``atol 1e-5 · max|g_ref|`` of the leaf (elements near zero are sums that
    cancel, whose float32 rounding is of the leaf's largest terms); leaves
    of a Mamba-2 mixer take ``atol 1e-4 · max|g_ref|``, as the port's SSD,
    which batches the chunk products in another order, is held to 2e-4 of
    the reference's scan in its forward (``tests/test_torch_mamba2.py``);
  * parameters after 3 steps: within 1e-5, except at most one element in
    a thousand of a leaf (and at least one), none of them beyond 6 · lr,
    the farthest three steps can take two runs apart: AdamW divides each
    element's gradient by its own root-mean-square, so an element whose
    gradient sits at the float32 rounding of its sum moves by ±lr either
    way (measured: one element in 4,096 to 32,768, 1.2e-5 to 2.9e-5).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models as JM
from repro.configs import get_smoke_config
from repro.train import optimizer as jopt
from repro.train.trainer import TrainPolicy as JPolicy
from repro.train.trainer import _loss_for_batch as j_loss
from repro.train.trainer import make_train_step as j_make
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models.interop import params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import TrainPolicy as TPolicy
from repro_torch.train.trainer import make_train_step as t_make
from repro_torch.train.tree import tree_leaves, tree_paths

VARIANTS = ("adamw", "microbatches2", "adafactor")
B, S, STEPS = 2, 16, 3
LR = {"adamw": 3e-4, "adafactor": 1e-3}   # the optimizers' defaults


def batch_for(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.modality == "audio_stub":
        batch["features"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.mrope_sections:
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
    return batch


@functools.lru_cache(maxsize=None)
def _reference_grads(arch: str, n_mb: int):
    """The reference's loss and gradients at the initial weights: of the
    whole batch, or summed over its strided microbatches and divided by
    their number, as its train step accumulates them."""
    cfg = get_smoke_config(arch)
    params = JM.init_model(jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(v) for k, v in batch_for(cfg).items()}
    vg = jax.jit(jax.value_and_grad(
        lambda p, mb: j_loss(p, cfg, mb, JPolicy())))
    loss, grads = 0.0, None
    for m in range(n_mb):
        mb = {k: (v[:, m::n_mb] if k == "positions" else v[m::n_mb])
              for k, v in batch.items()}
        lm, gm = vg(params, mb)
        loss = loss + lm
        grads = gm if grads is None else jax.tree.map(jnp.add, grads, gm)
    grads = jax.tree.map(lambda g: g / n_mb, grads)
    return float(loss / n_mb), dict(tree_paths(jax.device_get(grads)))


def check_train_step(arch: str, variant: str) -> None:
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    opt_name = "adafactor" if variant == "adafactor" else "adamw"
    n_mb = 2 if variant == "microbatches2" else 1
    params = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    batch = batch_for(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jo, to = getattr(jopt, opt_name)(), getattr(topt, opt_name)()
    j_step = jax.jit(j_make(cfg, jo, JPolicy(microbatches=n_mb)))
    t_step = t_make(tcfg, to, TPolicy(microbatches=n_mb))
    js, ts = jo.init(params), to.init(tp)

    for i in range(STEPS):
        params, js, jm = j_step(params, js, jb)
        tp, ts, tm = t_step(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        if i == 0:  # the gradients the first update took
            want_loss, want = _reference_grads(arch, n_mb)
            np.testing.assert_allclose(float(tm["loss"]), want_loss,
                                       rtol=1e-5)
            for path, p in tree_paths(tp):
                assert p.grad is not None, path
                ref = np.asarray(want[path], np.float32)
                scale = 1e-4 if "mixer" in path and _is_mamba(tp, path) \
                    else 1e-5
                np.testing.assert_allclose(
                    p.grad.numpy(), ref, rtol=1e-4,
                    atol=scale * float(np.abs(ref).max()),
                    err_msg=f"gradient {'|'.join(path)}")
    want_params = dict(tree_paths(jax.device_get(params)))
    lr = LR[opt_name]
    for path, p in tree_paths(tp):
        got, ref = p.detach().numpy(), np.asarray(want_params[path])
        diff = np.abs(got - ref)
        off = int((diff > 1e-5).sum())
        assert off <= max(1, diff.size // 1000), (path, off, diff.max())
        assert diff.max() <= 6 * lr, (path, diff.max())


def _is_mamba(tree, path) -> bool:
    """Whether ``path`` lies in a Mamba-2 mixer (its params hold
    ``dt_bias``)."""
    node = tree
    for key in path[:path.index("mixer") + 1]:
        node = node[key]
    return "dt_bias" in node
