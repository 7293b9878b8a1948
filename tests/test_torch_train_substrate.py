"""The port's training substrate on the CPU: the seven cases of
``tests/test_train_substrate.py`` (optimizers, checkpoints, int8
compression, the elastic mesh plan and the resilient loop) over trees of
tensors, the optimizers against the reference's update, and checkpoints
that cross between the two packages bit for bit in both directions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.train.checkpoint import (Checkpointer, latest_step,  # noqa: E402
                                          restore_checkpoint, save_checkpoint)
from repro_torch.train.compression import (apply_error_feedback,  # noqa: E402
                                           dequantize_int8, init_error_state,
                                           quantize_int8)
from repro_torch.train.fault_tolerance import ResilientLoop, plan_mesh  # noqa: E402
from repro_torch.train.optimizer import adafactor, adamw, global_norm  # noqa: E402
from repro_torch.train.tree import tree_leaves, tree_map, tree_paths  # noqa: E402


def _toy_np(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 16)).astype(np.float32),
            "b": rng.normal(size=(16,)).astype(np.float32),
            "nested": {"u": rng.normal(size=(4, 4, 4)).astype(np.float32)}}


def _toy_params(seed):
    return tree_map(torch.from_numpy, _toy_np(seed))


@pytest.mark.parametrize("make_opt", [adamw, adafactor])
def test_optimizer_reduces_quadratic(make_opt):
    opt = make_opt(lr=0.1)
    params = _toy_params(0)
    target = _toy_params(9)
    state = opt.init(params)

    def loss_fn(p):
        return sum(torch.sum((a - b) ** 2)
                   for a, b in zip(tree_leaves(p), tree_leaves(target)))

    first = float(loss_fn(params).detach())
    for _ in range(60):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss_fn(params).backward()
        grads = tree_map(lambda p: p.grad, params)
        params, state, metrics = opt.update(grads, state, params)
    assert float(loss_fn(params).detach()) < 0.2 * first
    assert np.isfinite(float(metrics["grad_norm"]))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(name):
    """Five updates from the same gradients: parameters, state and norm
    within 1e-6 (float32 rounding of the same formulas)."""
    jo, to = getattr(j_opt, name)(), getattr(
        __import__("repro_torch.train.optimizer", fromlist=[name]), name)()
    jp = tree_map(jnp.asarray, _toy_np(0))
    tp = _toy_params(0)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(5):
        g = _toy_np(10 + i)
        jp, js, jm = jo.update(tree_map(jnp.asarray, g), js, jp)
        tp, ts, tm = to.update(tree_map(torch.from_numpy, g), ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    for (pa, a), (pb, b) in zip(tree_paths(jax.device_get((jp, js))),
                                tree_paths((tp, ts))):
        assert pa == pb
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6,
                                   atol=1e-6, err_msg="|".join(pa))


def test_optimizer_state_structure_stable():
    """The update keeps the state tree's structure (and its tensors)."""
    opt = adamw()
    params = _toy_params(0)
    state = opt.init(params)
    before = [(p, id(t)) for p, t in tree_paths(state)]
    grads = tree_map(torch.ones_like, params)
    _, new_state, _ = opt.update(grads, state, params)
    assert [(p, id(t)) for p, t in tree_paths(new_state)] == before
    assert float(global_norm(grads)) == pytest.approx(
        np.sqrt(8 * 16 + 16 + 64))


def test_checkpoint_roundtrip(tmp_path):
    tree = {"params": _toy_params(1), "step_scalar": torch.tensor(7)}
    save_checkpoint(str(tmp_path), 42, tree)
    assert latest_step(str(tmp_path)) == 42
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 42
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        assert torch.equal(a, b)


def test_checkpoint_retention_and_corruption(tmp_path):
    tree = {"w": torch.ones(4)}
    for s in (10, 20, 30, 40):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [30, 40]
    (tmp_path / "step_00000040" / "manifest.json").write_text("{broken")
    assert latest_step(str(tmp_path)) == 30


def _train_state(seed):
    """A (params, AdamW state) pair after one update, as the launcher
    checkpoints it."""
    params = _toy_params(seed)
    opt = adamw()
    state = opt.init(params)
    params, state, _ = opt.update(tree_map(torch.from_numpy, _toy_np(seed + 1)),
                                  state, params)
    return params, state


def test_checkpoint_reference_saves_port_restores(tmp_path):
    jp = tree_map(jnp.asarray, _toy_np(2))
    jo = j_opt.adamw()
    jp, js, _ = jo.update(tree_map(jnp.asarray, _toy_np(3)), jo.init(jp), jp)
    j_ckpt.save_checkpoint(str(tmp_path), 5, (jp, js))
    template = _train_state(0)
    (tp, ts), step = restore_checkpoint(str(tmp_path), template)
    assert step == 5
    for (pa, a), (pb, b) in zip(tree_paths(jax.device_get((jp, js))),
                                tree_paths((tp, ts))):
        assert pa == pb
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), "|".join(pa)


def test_checkpoint_port_saves_reference_restores(tmp_path):
    tp, ts = _train_state(4)
    save_checkpoint(str(tmp_path), 6, (tp, ts))
    jp = tree_map(jnp.asarray, _toy_np(0))
    template = (jp, j_opt.adamw().init(jp))
    (rp, rs), step = j_ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 6
    for (pa, a), (pb, b) in zip(tree_paths((tp, ts)),
                                tree_paths(jax.device_get((rp, rs)))):
        assert pa == pb
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), "|".join(pa)


def test_int8_error_feedback_reduces_bias():
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.normal(size=(256,)) * 1e-3).astype(np.float32))
    grads = {"g": g}
    err = init_error_state(grads)
    naive_sum = np.zeros(256)
    ef_sum = np.zeros(256)
    for _ in range(50):
        q, s = quantize_int8(g)
        naive_sum += dequantize_int8(q, s).numpy()
        restored, err = apply_error_feedback(grads, err)
        ef_sum += restored["g"].numpy()
    true_sum = g.numpy() * 50
    assert np.abs(ef_sum - true_sum).max() < np.abs(naive_sum - true_sum).max()


def test_plan_mesh_elasticity():
    assert plan_mesh(512) == ((2, 16, 16), ("pod", "data", "model"))
    assert plan_mesh(256) == ((16, 16), ("data", "model"))
    shape, axes = plan_mesh(248)
    assert axes == ("data", "model") and shape == (15, 16)
    with pytest.raises(ValueError):
        plan_mesh(8)


def test_resilient_loop_recovers_from_failure(tmp_path):
    """A mid-run failure restores the checkpoint and replays data."""
    ckpt = Checkpointer(str(tmp_path), interval=2)
    calls = {"n": 0}

    def step_fn(state, batch):
        return state + batch, float(state)

    def fail_once(step):
        if step == 5 and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected node failure")

    def data_factory():
        return iter([1] * 100)

    loop = ResilientLoop(step_fn, ckpt, lambda: {"consumed": 0},
                         lambda s: None, max_retries=2)
    state, report = loop.run(torch.tensor(0), data_factory, num_steps=10,
                             fail_hook=fail_once)
    assert report.retries == 1
    assert report.restores == 1
    assert report.steps_run >= 10
    assert int(state) == 10


@pytest.mark.parametrize("remat,policy", [(True, "full"), (True, "dots")])
def test_recomputation_gives_the_gradients_of_the_plain_backward(remat,
                                                                 policy):
    """``forward(remat=True)`` recomputes each period in the backward
    (``remat_policy`` "full", or "dots" keeping the matrix products): the
    loss and every gradient equal those without recomputation, within
    1e-6 of the leaf's largest magnitude (the same float32 operations,
    run again)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.train.trainer import TrainPolicy, _loss_for_batch

    cfg = get_smoke_config("jamba-1.5-large-398b")
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    grads = {}
    for name, pol in (("plain", TrainPolicy(remat=False)),
                      ("remat", TrainPolicy(remat=remat,
                                            remat_policy=policy))):
        params = init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss = _loss_for_batch(params, cfg, batch, pol)
        loss.backward()
        grads[name] = (float(loss.detach()),
                       [(path, p.grad) for path, p in tree_paths(params)])
    assert grads["remat"][0] == pytest.approx(grads["plain"][0], rel=1e-6)
    for (path, a), (_, b) in zip(grads["remat"][1], grads["plain"][1]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()),
                                   msg=str(path))
