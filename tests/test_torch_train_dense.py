"""The port's train step against the reference's on the CPU for the smoke
configs of the dense GQA architectures (Yi-9B, Gemma-2 with its
soft-caps and local/global layers, StarCoder2, Yi-34B): loss, every
gradient leaf and the parameters after 3 steps, with AdamW, with 2
microbatches and with Adafactor.  The
tolerances and their reasons are in ``torch_train_common``."""
import pytest

torch = pytest.importorskip("torch")

from torch_train_common import VARIANTS, check_train_step  # noqa: E402

ARCHS = ["yi-9b", "gemma2-9b", "starcoder2-15b", "yi-34b"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, variant):
    check_train_step(arch, variant)
