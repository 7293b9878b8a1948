"""The port's bfloat16 train step against the reference's on the CPU for
the smoke configs of Phi-3.5-MoE and DeepSeek-V2-Lite (MLA, shared
experts), from the reference's bf16 weights with AdamW: the loss of 3
steps, step 0's gradients against the float32 gradients as relative L2
errors, the parameters afterwards.  The tolerances and their reasons are
in ``torch_train_common.check_bf16_train_step``."""
import pytest

torch = pytest.importorskip("torch")

from torch_train_common import check_bf16_train_step  # noqa: E402


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-lite-16b"])
def test_bf16_train_step_matches_reference(arch):
    check_bf16_train_step(arch)
