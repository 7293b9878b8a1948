"""The port's train step against the reference's on the CPU for the smoke
configs of Mamba2-370m, Qwen2-VL (M-RoPE, biased QKV) and the encoder
HuBERT: loss, every gradient leaf and the parameters after 3 steps, with
AdamW, with 2 microbatches and with Adafactor.  The
tolerances and their reasons are in ``torch_train_common``."""
import pytest

torch = pytest.importorskip("torch")

from torch_train_common import VARIANTS, check_train_step  # noqa: E402

ARCHS = ["mamba2-370m", "qwen2-vl-7b", "hubert-xlarge"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, variant):
    check_train_step(arch, variant)
