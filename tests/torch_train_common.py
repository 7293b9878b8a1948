"""Shared by ``tests/test_torch_train_{moe,moe_deepseek,moe_jamba,dense,other}.py`` and
``tests/test_torch_train_bf16_*.py``: one architecture's smoke
config trained by the reference's ``make_train_step`` and by the port's on
the same batch, from the same weights (the reference's, handed across with
``params_from_numpy``), on the CPU, in float32 (:func:`check_train_step`)
or in bfloat16 (:func:`check_bf16_train_step`, whose tolerances are in its
docstring).

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


# ---------------------------------------------------------------------------
# bfloat16 training
# ---------------------------------------------------------------------------

#: the >100 B hybrid's policy (the reference's ``default_policy``):
#: Adafactor with bf16 gradient sums, here over 2 microbatches so that the
#: bf16 accumulation runs
HYBRID = "hybrid_bf16_accum"
BF16_LOSS_RTOL = 3e-3
#: Jamba's loss after an update (see :func:`check_bf16_train_step`)
BF16_JAMBA_LOSS_RTOL = 2e-2
BF16_TREE_RATIO = 1.25
BF16_LEAF_ERR = 0.3


def rel_l2(got: dict, want: dict):
    """Each leaf's ``‖got − want‖ / ‖want‖`` and the whole tree's, in
    float64."""
    per, num, den = {}, 0.0, 0.0
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        d2 = float(((np.asarray(got[path], np.float64) - w) ** 2).sum())
        w2 = float((w * w).sum())
        per[path] = float(np.sqrt(d2 / w2)) if w2 else float(np.sqrt(d2))
        num, den = num + d2, den + w2
    return per, float(np.sqrt(num / den))


def reference_grads_at(arch: str, params, n_mb: int, accum_dtype) -> dict:
    """The reference's gradients at ``params`` (in their dtype), summed
    over the strided microbatches in ``accum_dtype`` and divided by their
    number, as its train step takes them; float32 numpy leaves."""
    cfg = get_smoke_config(arch)
    batch = {k: jnp.asarray(v) for k, v in batch_for(cfg).items()}
    vg = jax.jit(jax.grad(lambda p, mb: j_loss(p, cfg, mb, JPolicy())))
    grads = jax.tree.map(lambda p: jnp.zeros(p.shape, accum_dtype), params)
    for m in range(n_mb):
        mb = {k: (v[:, m::n_mb] if k == "positions" else v[m::n_mb])
              for k, v in batch.items()}
        grads = jax.tree.map(lambda a, g: a + g.astype(accum_dtype), grads,
                             vg(params, mb))
    grads = jax.tree.map(lambda g: (g / n_mb).astype(jnp.float32), grads)
    return dict(tree_paths(jax.device_get(grads)))


def bf16_gradient_errors(arch: str, tp, params, n_mb: int = 1,
                         accum_dtype=jnp.float32):
    """The port's gradients (``.grad`` of ``tp``) and the reference's bf16
    gradients at ``params``, each as relative L2 errors (:func:`rel_l2`)
    against the reference's float32 gradients at the same bf16-valued
    weights: ``(port per leaf, port tree, reference per leaf, reference
    tree)``."""
    f32 = reference_grads_at(
        arch, jax.tree.map(lambda p: p.astype(jnp.float32), params), n_mb,
        jnp.float32)
    ref = reference_grads_at(arch, params, n_mb, accum_dtype)
    port = {}
    for path, p in tree_paths(tp):
        assert p.grad is not None, path
        port[path] = p.grad.float().numpy()
    return (*rel_l2(port, f32), *rel_l2(ref, f32))


def check_bf16_train_step(arch: str, variant: str = "adamw") -> None:
    """Three steps in bfloat16 from the reference's ``init_model(PRNGKey(0),
    cfg, jnp.bfloat16)`` in both packages (AdamW; or, ``variant``
    :data:`HYBRID`, Adafactor with 2 microbatches summed in bf16).

    bf16 gradients cannot be held element for element: at the smoke sizes
    both packages' lie 15–50% of a leaf's largest magnitude from the
    float32 gradient, since each package rounds every op's output to bf16
    at other places (XLA keeps a fused chain in float32 where torch rounds
    each op; with ``--xla_allow_excess_precision=false`` the reference's
    Phi-3.5-MoE losses meet the port's within 9e-6), and they differ from
    each other by as much.  So:
      * loss: rtol ``BF16_LOSS_RTOL`` 3e-3 at every step (measured: at most
        1.4e-3), but Jamba's after its first update,
        ``BF16_JAMBA_LOSS_RTOL`` 2e-2: its bf16 loss after an update moves
        by up to 8.4e-3 between the reference's own two XLA rounding modes
        (excess precision on and off), and the port's lay 3.7e-3 (AdamW)
        and 1.23e-2 (the hybrid's policy) from the reference's;
      * step 0's gradients, as relative L2 errors against the reference's
        float32 gradients at the same bf16-valued weights: the port's
        whole tree at most ``BF16_TREE_RATIO`` 1.25 times the reference's
        bf16 error (measured 0.67–1.04 times), each leaf at most
        ``BF16_LEAF_ERR`` 0.3 (measured: at most 0.24);
      * parameters after 3 steps: each element within 2 bf16 ulps of the
        reference's plus 6 · lr: AdamW moves an element whose gradient
        sign differs between the packages by ±lr a step, and each step's
        bf16 rounding adds to that drift (measured: at most 0.92 of the
        room); the RMSNorm scales start at zero, where an ulp is no room.
        Adafactor's clipping bounds the RMS of a leaf's update by lr, not
        each element's, so the hybrid's case takes 12 · lr (measured: its
        worst element 8.3 · lr apart, 1.19 times 6 · lr + 2 ulps).
    """
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    hybrid = variant == HYBRID
    opt_name, n_mb = ("adafactor", 2) if hybrid else ("adamw", 1)
    j_acc, t_acc = ((jnp.bfloat16, torch.bfloat16) if hybrid
                    else (jnp.float32, torch.float32))
    params = JM.init_model(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    params0 = params
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    batch = batch_for(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jo, to = getattr(jopt, opt_name)(), getattr(topt, opt_name)()
    j_step = jax.jit(j_make(cfg, jo, JPolicy(
        optimizer=opt_name, microbatches=n_mb, grad_accum_dtype=j_acc)))
    t_step = t_make(tcfg, to, TPolicy(optimizer=opt_name,
                                      microbatches=n_mb,
                                      grad_accum_dtype=t_acc))
    js, ts = jo.init(params), to.init(tp)

    for i in range(STEPS):
        params, js, jm = j_step(params, js, jb)
        tp, ts, tm = t_step(tp, ts, tb)
        rtol = (BF16_JAMBA_LOSS_RTOL if i and arch.startswith("jamba")
                else BF16_LOSS_RTOL)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=rtol, err_msg=f"loss, step {i}")
        if i == 0:
            port, port_tree, ref, ref_tree = bf16_gradient_errors(
                arch, tp, params0, n_mb, j_acc)
            assert port_tree <= BF16_TREE_RATIO * ref_tree, (
                port_tree, ref_tree)
            worst = max(port, key=port.get)
            assert port[worst] <= BF16_LEAF_ERR, (
                worst, port[worst], ref[worst])
    want_params = dict(tree_paths(jax.device_get(params)))
    drift = (12 if hybrid else 6) * LR[opt_name]
    for path, p in tree_paths(tp):
        ref = np.asarray(want_params[path], np.float32)
        diff = np.abs(p.detach().float().numpy() - ref)
        # a bf16 ulp: float32's spacing times 2^16 (7 mantissa bits, not 23)
        room = 2 * np.spacing(np.abs(ref)) * 2.0 ** 16 + drift
        assert (diff <= room).all(), (path, float(diff.max()),
                                      float((diff / room).max()))
