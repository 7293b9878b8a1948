"""The port's train step against the reference's on the CPU for the smoke
config of Jamba-1.5 (the attention/Mamba-2 hybrid with MoE): loss, every gradient leaf and the parameters after 3
steps, with AdamW, with 2 microbatches and with Adafactor.  The
tolerances and their reasons are in ``torch_train_common``.  The MoE
architectures' cases are split one file an architecture
(``test_torch_train_moe{,_deepseek,_jamba}.py``), so that no file holds the CPU suite's
wall time on one worker."""
import pytest

torch = pytest.importorskip("torch")

from torch_train_common import VARIANTS, check_train_step  # noqa: E402

ARCHS = ["jamba-1.5-large-398b"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, variant):
    check_train_step(arch, variant)
