"""``python -m repro_torch.launch.train --device cpu --smoke``: four steps
through the data pipeline, the trainer and AdamW, and the same four steps
as two, a checkpoint, a restart and two more, whose losses and final
parameters equal the uninterrupted run's exactly (the CPU's plain
versions are deterministic)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402
from repro_torch.train.tree import tree_paths  # noqa: E402

ARGS = ["--device", "cpu", "--smoke", "--arch", "phi3.5-moe-42b-a6.6b",
        "--seq-len", "32", "--batch", "2"]


def test_train_resumes_from_its_checkpoint(tmp_path):
    whole = train.main(ARGS + ["--steps", "4"])
    assert sorted(whole["losses"]) == [0, 1, 2, 3]
    assert all(torch.isfinite(torch.tensor(v))
               for v in whole["losses"].values())
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-interval", "2"]
    first = train.main(ARGS + ckpt + ["--steps", "2"])
    assert first["start"] == 0
    assert [first["losses"][s] for s in (0, 1)] == \
        [whole["losses"][s] for s in (0, 1)]
    assert (tmp_path / "step_00000002" / "arrays.npz").is_file()
    resumed = train.main(ARGS + ckpt + ["--steps", "4"])
    assert resumed["start"] == 2
    assert resumed["losses"] == {s: whole["losses"][s] for s in (2, 3)}
    for (pa, a), (pb, b) in zip(tree_paths(whole["params"]),
                                tree_paths(resumed["params"])):
        assert pa == pb
        assert torch.equal(a, b), "|".join(pa)
        assert b.requires_grad
    assert int(resumed["opt_state"]["step"]) == 4
