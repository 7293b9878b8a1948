"""The port's bfloat16 train step against the reference's on the CPU for
the smoke configs of Gemma-2 (window and soft-caps), Mamba2-370m and
Yi-9B, from the reference's bf16 weights, with AdamW.  The tolerances and
their reasons are in ``torch_train_common.check_bf16_train_step``."""
import pytest

torch = pytest.importorskip("torch")

from torch_train_common import check_bf16_train_step  # noqa: E402


@pytest.mark.parametrize("arch", ["gemma2-9b", "mamba2-370m", "yi-9b"])
def test_bf16_train_step_matches_reference(arch):
    check_bf16_train_step(arch)
