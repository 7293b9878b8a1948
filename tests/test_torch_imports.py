"""The port stands alone: ``repro_torch`` imports neither JAX nor the
reference package, its entry points run on CUDA unless the caller asks for
the CPU, and ``chip_smoke.py`` refuses to run without a card or outside a
checkout."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PKG = SRC / "repro_torch"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'repro' or"
        " m.startswith('repro.') or m.startswith('jax')]\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    # core + kernels + device + configs + models + serving + launch
    assert int(out.stdout.strip()) >= 55


@pytest.mark.parametrize("module", [
    "repro_torch.core.server", "repro_torch.core.slo",
    "repro_torch.kernels.multikey_sort.ops",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.moe_dispatch.ops", "repro_torch.models",
    "repro_torch.models.interop", "repro_torch.serving.engine",
    "repro_torch.launch.serve", "repro_torch.configs",
    "repro_torch.distributed.sharding", "repro_torch.core.partition",
    "repro_torch.models.mamba2", "repro_torch.serving.kv_quant",
    "repro_torch.roofline", "repro_torch.train.optimizer",
    "repro_torch.train.trainer", "repro_torch.train.checkpoint",
    "repro_torch.train.compression", "repro_torch.train.fault_tolerance",
    "repro_torch.data.pipeline", "repro_torch.launch.train"])
def test_serving_and_sort_modules_stand_alone(module):
    """The serving layer and the sort kernel's package load with JAX
    blocked and pull in nothing of JAX or the reference."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m == 'repro' or"
        " m.startswith('repro.') or m.startswith('jax')]\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_import_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                     r"from\s+(jax|repro)(\.|\s)(?!_))", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    for path in files:
        hits = pat.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)}: {hits}"


def test_session_without_cuda_raises(monkeypatch):
    from repro_torch.core import Executor, Session, tensor_join
    from repro_torch.core.relation import Relation

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Executor(1 << 20)
    rel = Relation({"k": np.arange(4, dtype=np.int64)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tensor_join(rel, rel, "k")


def test_lm_entry_points_without_cuda_raise(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import PipelineConfig, prepare_order
    from repro_torch.launch import serve, train
    from repro_torch.models import init_cache, init_model
    from repro_torch.models.interop import params_from_numpy
    from repro_torch.serving.engine import BatchScheduler

    _no_cuda(monkeypatch)
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    gen = torch.Generator()
    for call in (lambda: init_model(gen, cfg), lambda: init_cache(cfg, 1, 4),
                 lambda: BatchScheduler(4),
                 lambda: params_from_numpy({"w": np.zeros(2)}),
                 lambda: serve.main(["--smoke"]),
                 lambda: train.main(["--smoke", "--steps", "1"]),
                 lambda: prepare_order(PipelineConfig(num_docs=100))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_session_on_cpu_runs_the_tensor_path():
    from repro_torch.core import Session, col

    sess = Session(work_mem=1 << 20, policy="tensor", device="cpu")
    assert sess.device == torch.device("cpu")
    sess.register("t", {"k": np.arange(50, dtype=np.int64),
                        "w": np.arange(50, dtype=np.int64) - 25})
    sess.register("u", {"k": np.arange(0, 50, 2, dtype=np.int64),
                        "v": np.ones(25, np.int64)})
    res = (sess.table("t").join("u", on="k").filter(col("w") > 0)
           .aggregate("b_v", "sum").collect())
    assert res.scalar == 12.0
    assert [m.op for m in res.metrics] == ["fused_pipeline"]


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, where):
    """No result and a non-zero exit without CUDA, and in a directory that
    holds chip_smoke.py and nothing else of the repo."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, cwd=script.parent, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
