"""The yardstick of the kernels: the H100's peaks and the least bytes a
relational operation must move.

Peaks are NVIDIA's H100 SXM data sheet (dense rates, no sparsity), which
assume the card's full power limit of 700 W; a share of them is reported
with the card's ``nvidia-smi`` power limit beside it.  A count here depends
on the operation's inputs and result alone, never on which kernels happen
to carry it out, so a later change to the kernels cannot move it.
"""
from __future__ import annotations

#: HBM3 bandwidth of one H100 SXM, bytes/s
HBM_BW = 3.35e12
#: float32 outside the tensor cores, operations/s
PEAK_FLOPS_F32 = 67e12
#: the power limit the peaks assume, W
PEAK_POWER_W = 700.0

KEY_BYTES = 8       # an int64 join key, as the tables hold it
ROW_ID_BYTES = 4    # an int32 build-row number: every build side here has
                    # fewer than 2**31 rows
GROUP_OUT_BYTES = 8  # a group's key or aggregate, as an int64 or float64


def join_bytes(n_build: int, n_probe: int) -> int:
    """Least bytes an equi-join on one int64 key moves: each build key and
    each probe key read once, and for each probe row its matching build
    row's number written once (a key-foreign-key join: at most one
    match)."""
    return (n_build + n_probe) * KEY_BYTES + n_probe * ROW_ID_BYTES


def group_bytes(n_rows: int, widths, n_groups: int, n_aggs: int) -> int:
    """Least bytes a GROUP BY over ``n_rows`` moves: the key column and
    each summed column read once, ``widths`` being the bytes of one value
    of each (a count reads no column), and each of the ``n_groups``
    groups' key and ``n_aggs`` aggregates written once at
    :data:`GROUP_OUT_BYTES`."""
    return (n_rows * sum(widths)
            + n_groups * (1 + n_aggs) * GROUP_OUT_BYTES)


def least_seconds(nbytes: int, ops: int = 0) -> float:
    """Least time for the work on one H100: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    return max(nbytes / HBM_BW, ops / PEAK_FLOPS_F32)


def roofline_pct(least_s: float, device_s: float):
    """``least_s`` as a share of the device time that did the work, in %;
    ``None`` where no device time was seen (nothing to read)."""
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s
