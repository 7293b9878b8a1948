"""Checkpointing: atomic, resumable, numpy-backed, in the reference's
on-disk layout (``src/repro/train/checkpoint.py``), so a checkpoint that
either package writes restores into the other:

  <dir>/step_<N>.tmp/   (being written)
  <dir>/step_<N>/       (atomic rename after fsync: a crash never leaves a
                         half-written checkpoint visible)
      arrays.npz        ("|"-joined path of each leaf → array)
      manifest.json     (step, leaf count, per-leaf shape/dtype/sum)

Paths are ``jax.tree_util``'s: dict keys as strings, list and tuple
positions as indices, dict keys in sorted order.  The port writes
``arrays.npz`` one leaf at a time (the same zip of ``.npy`` members that
``np.savez`` writes), and restores one leaf at a time onto the template
leaf's device, so the host holds one leaf, not the whole state (34 GB for
AdamW at 2.86 B parameters).  A tensor leaf restores as a tensor of the
template's dtype and ``requires_grad``; any other leaf as a numpy array,
as the reference returns them.  bfloat16 leaves are stored as float32
(numpy has no bfloat16).

``latest_step`` scans for the newest *valid* manifest, so restore skips any
checkpoint that fails integrity checks.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models.interop import params_to_numpy
from .tree import tree_paths, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "Checkpointer"]

_SEP = "|"


def _leaf_sum(v: np.ndarray) -> float:
    return float(np.sum(v, dtype=np.float64)) if v.dtype.kind in "fiu" \
        else 0.0


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves = {}
    with zipfile.ZipFile(tmp / "arrays.npz", mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for path, leaf in tree_paths(tree):
            key = _SEP.join(path)
            arr = np.asarray(params_to_numpy(leaf))
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            leaves[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                           "sum": _leaf_sum(arr)}
            del arr
    manifest = {"step": step, "num_leaves": len(leaves), "leaves": leaves}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic visibility
    # retention
    steps = sorted(_valid_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
    return str(final)


def _valid_steps(ckpt_dir: pathlib.Path):
    out = []
    for p in ckpt_dir.glob("step_*"):
        if p.suffix == ".tmp" or not (p / "manifest.json").exists():
            continue
        try:
            m = json.loads((p / "manifest.json").read_text())
            out.append(int(m["step"]))
        except Exception:
            continue
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = _valid_steps(d)
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, like):
    if not isinstance(like, torch.Tensor):
        return arr
    t = torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    return t.requires_grad_(like.requires_grad)


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``template``."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    leaves = []
    with np.load(path / "arrays.npz") as data:
        for p, like in tree_paths(template):
            key = _SEP.join(p)
            arr = data[key]
            if list(arr.shape) != manifest["leaves"][key]["shape"]:
                raise ValueError(f"checkpoint corrupt: {key} shape mismatch")
            leaves.append(_restore_leaf(arr, like))
            del arr
    return tree_unflatten(template, leaves), int(manifest["step"])


class Checkpointer:
    """Interval-based checkpointing helper for the train loop."""

    def __init__(self, ckpt_dir: str, interval: int = 100, keep: int = 3):
        self.dir = ckpt_dir
        self.interval = interval
        self.keep = keep

    def maybe_save(self, step: int, tree: Any) -> Optional[str]:
        if step % self.interval == 0 and step > 0:
            return save_checkpoint(self.dir, step, tree, self.keep)
        return None

    def restore_or_init(self, template: Any, init_fn):
        s = latest_step(self.dir)
        if s is None:
            return init_fn(), 0
        return restore_checkpoint(self.dir, template, s)
