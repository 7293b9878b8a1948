"""The port's LM serving path (``repro_torch.serving``,
``repro_torch.launch.serve``) against the reference's on the CPU: the
scheduler admits in the reference's order, greedy ``generate`` gives the
reference's tokens on the same weights, and the serve entry point runs."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models as JM  # noqa: E402
import repro.serving.engine as JE  # noqa: E402
import repro_torch.serving.engine as TE  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro_torch import device as D  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402


def _fill(E, sched, spec):
    for rid, pri, t in spec:
        r = E.Request(rid=rid, prompt=np.zeros(4, np.int64),
                      max_new_tokens=1, priority=pri)
        r.arrived_s = t
        sched.submit(r)


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_order_matches_reference(seed):
    rng = np.random.default_rng(seed)
    spec = [(i, int(rng.integers(0, 3)), float(rng.integers(0, 5)) + 0.25 * i)
            for i in range(11)]
    if seed == 0:  # the reference test's own case leads
        spec = [(0, 0, 1.0), (1, 2, 3.0), (2, 2, 2.0), (3, 1, 0.5)] + spec[4:]
    ref, port = JE.BatchScheduler(3), TE.BatchScheduler(3, device="cpu")
    _fill(JE, ref, spec)
    _fill(TE, port, spec)
    while ref.queue:
        assert ([r.rid for r in port.admit(3)]
                == [r.rid for r in ref.admit(3)])
    assert not port.queue and port.admit(3) == []


@pytest.mark.parametrize("arch", ["yi-9b", "phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-lite-16b", "mamba2-370m",
                                  "jamba-1.5-large-398b"])
def test_generate_matches_reference_tokens(arch):
    cfg = get_smoke_config(arch)
    params = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6))
    want = JE.generate(params, cfg, prompts, max_new_tokens=4)
    times = []
    got = TE.generate(tp, t_smoke(arch), prompts, max_new_tokens=4,
                      step_seconds=times)
    assert got.shape == (2, 4) and len(times) == 6 + 4 - 1
    np.testing.assert_array_equal(got, want)


def test_prefill_step_then_decode_continues_the_prompt():
    """``make_prefill_step``'s cache, copied into a longer cache, carries
    decode on exactly as stepwise decode from the start does."""
    cfg = t_smoke("yi-9b")
    gen = torch.Generator().manual_seed(1)
    params = init_model(gen, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    last, cache = TE.make_prefill_step(cfg)(params, {"tokens": toks[:, :8]})
    full = TE.init_cache(cfg, 2, 9, device="cpu")
    for name in ("k", "v"):
        full["blocks"]["s0"][name][:, :, :8] = cache["blocks"]["s0"][name]
    full["pos"] = cache["pos"]
    step = TE.make_decode_step(cfg)
    lg, full = step(params, full, {"tokens": toks[:, 8:9]})
    ref = TE.init_cache(cfg, 2, 9, device="cpu")
    for t in range(9):
        lr, ref = step(params, ref, {"tokens": toks[:, t:t + 1]})
        if t == 7:
            torch.testing.assert_close(lr, last, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lg, lr, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-370m",
                                  "jamba-1.5-large-398b"])
def test_prefill_cache_continues_decode_for_mla_and_mamba(arch):
    """The prefill's cache carries decode on as stepwise decode from the
    start does: MLA's compressed entries and GQA's K/V copied into a longer
    cache at their positions, mamba's conv tail and SSD state taken over
    whole."""
    cfg = t_smoke(arch)
    params = init_model(torch.Generator().manual_seed(4), cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    last, cache = TE.make_prefill_step(cfg)(params, {"tokens": toks[:, :8]})
    full = TE.init_cache(cfg, 2, 9, device="cpu")
    for part in ("prefix", "blocks"):
        for slot, entry in (cache[part] or {}).items():
            for name, val in entry.items():
                dst = full[part][slot][name]
                if name in ("conv", "ssd"):
                    dst.copy_(val)
                else:  # positions: the axis after the batch
                    dst.narrow(1 + (part == "blocks"), 0, 8).copy_(val)
    full["pos"] = cache["pos"]
    step = TE.make_decode_step(cfg)
    lg, full = step(params, full, {"tokens": toks[:, 8:9]})
    ref = TE.init_cache(cfg, 2, 9, device="cpu")
    for t in range(9):
        lr, ref = step(params, ref, {"tokens": toks[:, t:t + 1]})
        if t == 7:
            torch.testing.assert_close(lr, last, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lg, lr, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-370m"])
def test_serve_runs_mla_and_mamba_on_cpu(arch, capsys):
    rep = serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                      "--requests", "3", "--batch-size", "2",
                      "--prompt-len", "4", "--max-new", "3"])
    assert rep["served"] == 3 and rep["tokens"] == 9
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out


def test_serve_smoke_runs_on_cpu(capsys):
    rep = serve.main(["--smoke", "--device", "cpu", "--arch",
                      "phi3.5-moe-42b-a6.6b", "--requests", "5",
                      "--batch-size", "2", "--prompt-len", "5",
                      "--max-new", "3"])
    assert rep["served"] == 5 and rep["tokens"] == 15
    assert sorted(sum(rep["batches"], [])) == list(range(5))
    assert "served 5 requests / 15 tokens" in capsys.readouterr().out


def test_to_host_brings_bfloat16_as_float32():
    x = torch.tensor([1.5, -2.25, 3e38], dtype=torch.bfloat16)
    (h,) = D.to_host([x])
    assert h.dtype == np.float32
    assert np.array_equal(h, x.float().numpy())
