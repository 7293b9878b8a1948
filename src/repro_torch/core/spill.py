"""Temp-file spill manager (PostgreSQL-style work_mem discipline).

Spills are *real* file I/O: the linear execution path writes partition /
sort-run files to a temp directory and reads them back, and every byte is
accounted in a :class:`SpillAccount`.  This is what lets the benchmarks
reproduce the paper's Temp_MB / block counts and the latency impact of the
spill regime, rather than simulating them.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from typing import Dict, Optional

import numpy as np

from .faults import FaultInjector, SimulatedCrash, SpillCorruptionError
from .metrics import SpillAccount
from .relation import Relation

__all__ = ["SpillManager", "RunReader", "column_crc32", "CHECKSUM_FILE"]

# Per-column CRC32 manifest written alongside the .npy files (not itself a
# column: readers iterate *.npy only).  Extends the crash-consistency
# story to READS: the atomic rename guarantees a complete directory, the
# manifest guarantees the bytes inside it are the bytes that were written.
CHECKSUM_FILE = "checksums.json"


def column_crc32(arr: np.ndarray) -> int:
    """CRC32 over a column's raw little-endian bytes (layout-independent)."""
    return zlib.crc32(np.ascontiguousarray(arr).data) & 0xFFFFFFFF


def verify_column(arr: np.ndarray, name: str, base: str,
                  manifest: Optional[Dict[str, int]]) -> None:
    """Raise :class:`SpillCorruptionError` when ``arr`` fails its recorded
    CRC.  A missing manifest (foreign/legacy spill dir) is accepted."""
    if manifest is None or name not in manifest:
        return
    got = column_crc32(arr)
    if got != manifest[name]:
        raise SpillCorruptionError(
            f"spill column {name!r} at {base!r} failed CRC32 "
            f"(expected {manifest[name]:#010x}, got {got:#010x}) — torn or "
            f"bit-flipped file")


def load_manifest(base: str) -> Optional[Dict[str, int]]:
    path = os.path.join(base, CHECKSUM_FILE)
    try:
        with open(path, "r") as f:
            return {str(k): int(v) for k, v in json.load(f).items()}
    except (OSError, ValueError):
        return None


class SpillManager:
    """Owns a temp directory; writes/reads columnar spill files with accounting.

    ``faults`` wires the spill-write path into a
    :class:`~repro_torch.core.faults.FaultInjector`: every column write first asks
    the injector, which may raise a transient
    :class:`~repro_torch.core.faults.SpillIOError` or a
    :class:`~repro_torch.core.faults.SimulatedCrash` (a mid-write worker death —
    the crash-consistency regression)."""

    def __init__(self, root: Optional[str] = None,
                 faults: Optional[FaultInjector] = None):
        self.dir = tempfile.mkdtemp(prefix="repro_spill_", dir=root)
        self.faults = faults
        self._counter = 0
        # logical bytes per live base path, so delete() can return the exact
        # footprint to the account (true live-occupancy tracking)
        self._sizes: Dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------------
    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
        self._sizes.clear()

    def __enter__(self) -> "SpillManager":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()

    def _next_path(self, tag: str) -> str:
        self._counter += 1
        return os.path.join(self.dir, f"{tag}_{self._counter:06d}")

    # -- columnar spill files --------------------------------------------------
    def write_relation(self, rel: Relation, tag: str, account: SpillAccount) -> str:
        """Write a relation as one .npy file per column; returns the base path.

        Crash-consistent finalize: columns land in a ``<base>.tmp`` staging
        directory, every file (and the directory entry) is fsynced, and only
        then is the directory atomically renamed to its final path.  A
        worker killed at ANY instant therefore leaves either a fully-visible
        complete run or an invisible ``.tmp`` orphan — never a final-named
        dir holding a readable-but-truncated relation (which
        ``read_relation``/``RunReader`` would return as silently wrong
        results).  An ordinary write failure (disk full, permission change
        mid-run) removes the staging dir before re-raising so no temp space
        leaks; a :class:`~repro_torch.core.faults.SimulatedCrash` deliberately
        skips that cleanup — a killed process runs no handlers, which is
        exactly what the crash-consistency regression exercises."""
        base = self._next_path(tag)
        tmp = base + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        total = 0
        manifest: Dict[str, int] = {}
        try:
            for name, col in rel.columns.items():
                path = os.path.join(tmp, name + ".npy")
                if self.faults is not None:
                    self.faults.on_spill_column(path)
                np.save(path, col, allow_pickle=False)
                with open(path, "rb") as f:
                    os.fsync(f.fileno())
                manifest[name] = column_crc32(col)
                account.write(col.nbytes)
                total += col.nbytes
            mpath = os.path.join(tmp, CHECKSUM_FILE)
            with open(mpath, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            dfd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
            os.rename(tmp, base)  # atomic publish: all columns or nothing
        except SimulatedCrash:
            raise  # a killed worker cleans nothing; .tmp quarantines the wreck
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        account.files_created += len(rel.columns)
        self._sizes[base] = total
        return base

    def read_relation(self, base: str, account: SpillAccount) -> Relation:
        manifest = load_manifest(base)
        cols: Dict[str, np.ndarray] = {}
        for fname in sorted(os.listdir(base)):
            if not fname.endswith(".npy"):
                continue
            path = os.path.join(base, fname)
            if self.faults is not None:
                self.faults.on_spill_read(path)
            arr = np.load(path, allow_pickle=False)
            verify_column(arr, fname[:-4], base, manifest)
            cols[fname[:-4]] = arr
            account.read(arr.nbytes)
        return Relation(cols)

    def open_run_reader(self, base: str, account: SpillAccount) -> "RunReader":
        return RunReader(base, account, faults=self.faults)

    def delete(self, base: str, account: Optional[SpillAccount] = None) -> None:
        """Remove a spill dir and, when an account is given, return its
        logical bytes to the account's live-occupancy counter."""
        freed = self._sizes.pop(base, None)
        if account is not None and freed is not None:
            account.free(freed)
        shutil.rmtree(base, ignore_errors=True)


class RunReader:
    """Chunked reader over a spilled relation (memory-mapped, counts bytes read)."""

    def __init__(self, base: str, account: SpillAccount,
                 faults: Optional[FaultInjector] = None):
        self.account = account
        self.cols: Dict[str, np.ndarray] = {}
        manifest = load_manifest(base)
        for fname in sorted(os.listdir(base)):
            if fname.endswith(".npy"):
                path = os.path.join(base, fname)
                if faults is not None:
                    faults.on_spill_read(path)
                arr = np.load(path, mmap_mode="r", allow_pickle=False)
                # CRC verification at open touches every page once — it is
                # the integrity gate for the whole merge pass; subsequent
                # read_rows() slices stay lazy via the mmap
                verify_column(arr, fname[:-4], base, manifest)
                self.cols[fname[:-4]] = arr
        if not self.cols:
            # a spill dir with no column files (zero-column relation, wrong
            # path, or a cleaned-up partial write) must fail loudly here —
            # `next(iter(...))` would raise bare StopIteration, which a
            # generator-based caller would swallow as silent end-of-stream
            raise ValueError(
                f"spill run at {base!r} contains no column files; cannot "
                f"determine row count")
        self.n = len(next(iter(self.cols.values())))
        self.pos = 0

    @property
    def exhausted(self) -> bool:
        return self.pos >= self.n

    def read_rows(self, nrows: int) -> Relation:
        end = min(self.n, self.pos + nrows)
        out = {}
        for name, col in self.cols.items():
            chunk = np.asarray(col[self.pos : end])  # materialize the slice
            out[name] = chunk
            self.account.read(chunk.nbytes)
        self.pos = end
        return Relation(out)
