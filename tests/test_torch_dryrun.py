"""``repro_torch.roofline.analyze`` (the reference's ``test_roofline``
cases on the port's counter), the dry-run planner
(``repro_torch.launch.dryrun``) on the fake 256-rank production mesh, and
the tables of ``repro_torch.roofline.report``.

Each dry-run cell runs as ``main`` runs it, in a process of its own (the
fake process group fixes its size for the process's life).  Its
per-device argument bytes must equal what the reference's sharding rules
give over the reference's ``jax.eval_shape`` trees, by the same
arithmetic (each dimension split by its axes' size).
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.distributed import sharding as r_sharding
from repro.launch import specs as r_specs
from repro.train.optimizer import make_optimizer as r_make_optimizer

from repro_torch.roofline import hw, report
from repro_torch.roofline.analyze import count_program, roofline_terms

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# -- the counter: the reference's test_roofline cases ------------------------

def test_dot_flops_counted():
    a, b = torch.zeros(128, 256), torch.zeros(256, 512)
    r = count_program(lambda: a @ b)
    want = 2 * 128 * 256 * 512
    assert abs(r["flops"] - want) / want < 0.05, (r["flops"], want)


@pytest.mark.parametrize("layers", [1, 10])
def test_layers_counted_each_time(layers):
    """The depth loop is Python: L layers count L times."""
    a = torch.zeros(64, 64)

    def fn():
        x = a
        for _ in range(layers):
            x = x @ a
        return x

    r = count_program(fn)
    want = layers * 2 * 64 ** 3
    assert abs(r["flops"] - want) / want < 0.05, (r["flops"], want)


def test_bytes_reasonable_for_elementwise():
    """y = x + 1 should move ~2·|x|, not orders of magnitude more."""
    x = torch.zeros(1 << 20)
    r = count_program(lambda: x + 1.0)
    assert x.nbytes <= r["bytes"] <= 4 * x.nbytes


def test_roofline_terms_dominance():
    # exactly 1 s of compute and 1 s of memory on the H100's rates
    t = roofline_terms(hw.PEAK_FLOPS_BF16, hw.HBM_BW, 0.0)
    assert t["dominant"] in ("compute", "memory")
    t = roofline_terms(1.0, 1.0, hw.NVLINK_BW * 10)
    assert t["dominant"] == "collective"
    assert 0 <= t["roofline_fraction"] <= 1


_PER_DEVICE = textwrap.dedent("""
    import json, torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline.analyze import Counter
    with fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        a = distribute_tensor(torch.empty(4096, 4096, device="meta"), mesh,
                              [Shard(0), Shard(1)])
        b = distribute_tensor(torch.empty(4096, 6400, device="meta"), mesh,
                              [Shard(0), Shard(1)])
        with Counter() as c:
            a @ b
        with FlopCounterMode(display=False) as f:
            a @ b
    print(json.dumps({"local": c.flops, "global": f.get_total_flops(),
                      "gather": c.coll["all-gather"],
                      "collective_ops": c.collective_ops}))
""")


def test_counter_counts_one_device_of_a_mesh():
    """On the fake 256-rank mesh the counter counts one device's flops
    (the global product's 1/256), where ``FlopCounterMode`` counts the
    global ones, and the gathers DTensor issues."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _PER_DEVICE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    want = 2 * 4096 * 4096 * 6400
    assert out["global"] == want
    assert out["local"] == want / 256
    assert out["gather"] > 0 and out["collective_ops"] >= 1


# -- the dry-run -------------------------------------------------------------

class _Mesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _local_bytes(tree, spec_tree) -> int:
    """Σ over leaves of each dimension split by its axes' size, times the
    itemsize: a leaf's bytes on one device."""
    from jax.sharding import PartitionSpec as P

    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(spec_tree,
                                      is_leaf=lambda x: isinstance(x, P))
    total = 0
    for leaf, spec in zip(leaves, specs):
        n = np.dtype(leaf.dtype).itemsize
        for i, dim in enumerate(leaf.shape):
            e = spec[i] if i < len(spec) else None
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= -(-dim // math.prod(_Mesh.shape[a] for a in axes))
        total += n
    return total


def _reference_argument_bytes(arch: str, shape: str) -> int:
    cfg = r_specs.sharded_config(r_get_config(arch))
    spec = R_SHAPES[shape]
    params = r_specs.abstract_params(cfg)
    total = _local_bytes(params, r_sharding.param_specs(params, cfg))
    batch = r_specs.input_specs(cfg, spec, spec.kind == "train")
    total += _local_bytes(batch, r_sharding.batch_specs(batch, _Mesh))
    if spec.kind == "train":
        opt = r_specs.abstract_opt_state(r_make_optimizer("adamw"), params)
        total += _local_bytes(opt, r_sharding.param_specs(opt, cfg))
    elif spec.kind == "decode":
        cache = r_specs.abstract_cache(cfg, spec.global_batch, spec.seq_len)
        # the port's position is a Python int, the reference's a scalar
        cache.pop("pos")
        total += _local_bytes(cache,
                              r_sharding.cache_specs(cache, cfg, _Mesh))
    return total


CELLS = [("mamba2-370m", "decode_32k"), ("phi3.5-moe-42b-a6.6b", "train_4k")]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC)
    records = {}
    for arch, shape in CELLS:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", str(out)],
            env=env, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
        with open(out / f"{arch}__{shape}__single.json") as f:
            records[(arch, shape)] = json.load(f)
    return out, records


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_cell(cells, arch, shape):
    _, records = cells
    r = records[(arch, shape)]
    assert r["status"] == "ok", r.get("traceback")
    assert r["mesh_shape"] == [16, 16]
    assert r["torch_version"] == torch.__version__
    assert r["memory_analysis"]["argument_size_in_bytes"] == \
        _reference_argument_bytes(arch, shape)
    assert r["memory_analysis"]["temp_size_in_bytes"] > 0
    walk = r["dispatch_walk"]
    assert walk["flops"] > 0 and walk["bytes"] > 0
    assert walk["collective_ops"] == sum(walk["comm_counts"].values())
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert r["model_flops_per_device"] == r["model_flops_total"] / 256
    assert 0 < r["useful_flops_ratio"]
    if arch.startswith("phi3.5-moe"):
        # the MoE layer is counted as the kernels run it: no one-hot
        # products, and each data rank runs its share of its experts'
        # rows; the rest is recomputation, capacity and the attention's
        # full score blocks (a one-hot plan counted 0.05)
        assert r["useful_flops_ratio"] > 0.25


def test_report_tables(cells):
    out, _ = cells
    d = str(out)
    table = report.dryrun_table(d)
    for arch, shape in CELLS:
        assert f"| {arch} | {shape} | single | ok | {torch.__version__} |" \
            in table
    assert report.roofline_table(d).count("\n") == 1 + len(CELLS)
    hbm = report.hbm_check(d)
    assert "(H100)" in hbm and hbm.count("\n") == 1 + len(CELLS)


_LINEAR = textwrap.dedent("""
    import json
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import sharded_config
    cfg = sharded_config(get_config("mamba2-370m"))
    shape = SHAPES["decode_32k"]
    with D.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        walks = {p: D._trace(D._depth(cfg, p), shape, mesh, None)[0]
                 for p in (1, 1, 2, 3)}   # the first 1: the warm-up
    got = D._extrapolate({(1, 1): walks[1], (2, 1): walks[2]}, 3, 1)
    print(json.dumps({"got": got, "want": walks[3]}))
""")


def test_extrapolated_counts_equal_a_longer_trace():
    """The dry-run's extrapolation from 1 and 2 periods equals the trace
    of 3: every period repeats the same ops."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _LINEAR], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("flops", "bytes", "transcendentals", "collective_bytes",
                "collective_ops", "temp_bytes", "comm_counts"):
        assert out["got"][key] == out["want"][key], key
