"""The port's roofline inputs (``repro_torch.roofline``) against the
reference's: ``model_flops`` equal, to float64 rounding, to the
reference's for every registered architecture at every assigned shape
and at the smoke script's prefill and decode shapes (MLA's and SSD's terms
included), and the H100 constants the smoke script reads."""
import pytest

pytest.importorskip("torch")

from repro.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro.configs.shapes import ShapeSpec as JShape  # noqa: E402
from repro.roofline.model_flops import model_flops as j_flops  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec as TShape  # noqa: E402
from repro_torch.roofline import hw, model_flops  # noqa: E402

#: the assigned shapes and chip_smoke.py's: a 2 x 4096 prefill, a decode
#: step of 4 sequences at 96 positions
EXTRA = [("smoke_prefill", 4096, 2, "prefill"),
         ("smoke_decode", 96, 4, "decode"), ("tiny_train", 64, 1, "train")]


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_match_reference(arch):
    cfg, tcfg = get_config(arch), t_config(arch)
    shapes = [(s.name, s.seq_len, s.global_batch, s.kind)
              for s in SHAPES.values()] + EXTRA
    for spec in shapes:
        got, want = model_flops(tcfg, TShape(*spec)), j_flops(cfg,
                                                               JShape(*spec))
        assert got == pytest.approx(want, rel=1e-12), (arch, spec)
        assert got > 0


def test_mla_and_ssd_terms_count():
    """DeepSeek-V2-Lite's prefill counts MLA's 192 + 128 widths and
    Mamba2's counts its SSD term: both exceed the parameter products
    alone."""
    for arch in ("deepseek-v2-lite-16b", "mamba2-370m"):
        cfg = t_config(arch)
        spec = TShape("p", 4096, 2, "prefill")
        assert model_flops(cfg, spec) > 2.0 * cfg.active_param_count() * 8192
    ds = t_config("deepseek-v2-lite-16b")
    attn = model_flops(ds, TShape("p", 4096, 2, "prefill")) \
        - 2.0 * ds.active_param_count() * 8192
    assert attn == pytest.approx(27 * 2 * 2.0 * 4096 * 4096 * 16
                                 * (192 + 128) * 0.5)


def test_h100_constants():
    assert hw.HBM_BW == 3.35e12 and hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.PEAK_FLOPS_TF32 == 494.7e12 and hw.PEAK_FLOPS_F32 == 67e12
