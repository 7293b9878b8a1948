"""The port's bfloat16 train step against the reference's on the CPU for
the smoke config of Jamba-1.5's hybrid (attention, Mamba-2 and MoE
layers), from the reference's bf16 weights with AdamW (its hybrid policy
is in ``test_torch_train_bf16_hybrid.py``).  The tolerances and their
reasons are in ``torch_train_common.check_bf16_train_step``."""
import pytest

torch = pytest.importorskip("torch")

from torch_train_common import check_bf16_train_step  # noqa: E402


def test_bf16_train_step_matches_reference():
    check_bf16_train_step("jamba-1.5-large-398b")
