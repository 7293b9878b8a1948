"""The port's train step against the reference's on the CPU for the smoke
configs of the MoE architectures (Phi-3.5-MoE, DeepSeek-V2-Lite's MLA
with shared experts, Jamba's hybrid): loss, every gradient leaf and the
parameters after 3 steps, with AdamW, with 2 microbatches and with
Adafactor.  The
tolerances and their reasons are in ``torch_train_common``."""
import pytest

torch = pytest.importorskip("torch")

from torch_train_common import VARIANTS, check_train_step  # noqa: E402

ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, variant):
    check_train_step(arch, variant)
