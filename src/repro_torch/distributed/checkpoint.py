"""Fault-tolerant checkpointing: atomic write-temp-then-rename, keep-N,
auto-resume (the reference's `distributed/checkpoint.py`, without JAX
and without `ml_dtypes`).

A tree is a flat `dict[str, array]`; its leaves may be numpy arrays or
CPU or CUDA tensors, and are stored as numpy arrays, one uncompressed
member each, in `step_<n>/arrays.npz`. `meta.json` records the step,
the leaf count, the extended dtypes (bfloat16 and the float8 types,
stored as a bit-identical unsigned integer view) and a CRC32 of every
leaf's bytes. The format is the reference's: a checkpoint written by
either package verifies and restores under the other.

Integrity: `verify` recomputes every leaf's CRC32 (the leaves read and
checked in threads) and raises
`CheckpointCorrupt` naming the file and leaf on any mismatch (npz
members are stored uncompressed, so a flipped bit loads cleanly and only
the checksum catches it). Auto-resume (`restore(step=None)`) walks the
checkpoints newest first and restores the newest intact one.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")

# extended dtypes numpy cannot hold: the torch dtype, the unsigned view
# stored in the archive, and the same-width integer view torch reads
_EXT_DTYPES = {"bfloat16": (torch.bfloat16, np.uint16, torch.int16),
               "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
               "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8)}
_EXT_NAME = {t: name for name, (t, _, _) in _EXT_DTYPES.items()}


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification: truncated archive,
    unreadable metadata, or a leaf whose bytes no longer match the CRC32
    recorded at save time. Carries the offending `path` and, for
    leaf-level damage, the leaf's key `leaf`."""

    def __init__(self, path: str, leaf: Optional[str] = None,
                 detail: str = ""):
        self.path = path
        self.leaf = leaf
        where = path + (f", leaf {leaf!r}" if leaf else "")
        super().__init__(f"corrupt checkpoint: {where}"
                         + (f" ({detail})" if detail else ""))


def _flatten(tree) -> dict:
    if not isinstance(tree, dict):
        raise TypeError(f"a checkpoint tree is a flat dict of arrays, got "
                        f"{type(tree).__name__}")
    return {str(k): v for k, v in tree.items()}


def _encode(flat: dict):
    """Numpy arrays to store, and the extended dtype of each leaf that
    has one."""
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            name = _EXT_NAME.get(v.dtype)
            if name is not None:
                _, store, tint = _EXT_DTYPES[name]
                arrays[k] = v.contiguous().view(tint).numpy().view(store)
                dtypes[k] = name
                continue
            v = v.numpy()
        arrays[k] = np.asarray(v)
    return arrays, dtypes


def _decode(arr: np.ndarray, key: str, dtypes: dict):
    """A stored leaf as its saved dtype: a numpy array, or a CPU tensor
    for an extended dtype."""
    name = dtypes.get(key)
    if not name:
        return arr
    tdtype, store, tint = _EXT_DTYPES[name]
    bits = np.ascontiguousarray(arr).view(store)
    signed = torch.empty(0, dtype=tint).numpy().dtype
    return torch.from_numpy(bits.view(signed).copy()).view(tdtype)


# leaves read and checksummed at once (zlib and file reads release the
# interpreter lock; past 4, threads contend for memory bandwidth)
_THREADS = min(4, os.cpu_count() or 1)


def _crc32(arr: np.ndarray) -> int:
    """CRC32 of an array's bytes in C order, read in place."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic checkpoint save; prunes to the newest `keep` steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    arrays, dtypes = _encode(flat)
    with ThreadPoolExecutor(_THREADS) as pool:
        crcs = dict(zip(arrays, pool.map(_crc32, arrays.values())))
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_arrays": len(flat),
                       "ext_dtypes": dtypes, "crc32": crcs}, f)
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                 # atomic on one filesystem
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def verify(ckpt_dir: str, step: int) -> Tuple[dict, dict]:
    """Load one checkpoint fully into memory and verify every leaf's
    CRC32 against meta.json. Returns `(arrays, ext_dtypes)`; raises
    `CheckpointCorrupt` (naming file and leaf) on truncation, unreadable
    metadata, a missing leaf, or a byte-level mismatch. Checkpoints
    written without the checksum field restore unverified."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    meta_path = os.path.join(d, "meta.json")
    npz_path = os.path.join(d, "arrays.npz")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(meta_path, detail=str(e)) from None
    try:
        with np.load(npz_path) as data:
            files = list(data.files)
    except Exception as e:       # zipfile/numpy errors on torn writes
        raise CheckpointCorrupt(npz_path, detail=str(e)) from None
    crcs = meta.get("crc32", {})
    for key in crcs:
        if key not in files:
            raise CheckpointCorrupt(npz_path, leaf=key,
                                    detail="leaf missing from archive")

    def load(k):
        try:                     # member by member: a zip-level CRC
            with np.load(npz_path) as data:     # failure names its leaf
                arr = data[k]
        except Exception as e:
            raise CheckpointCorrupt(npz_path, leaf=k, detail=str(e)) from None
        if k in crcs and _crc32(arr) != crcs[k]:
            raise CheckpointCorrupt(
                npz_path, leaf=k,
                detail=f"crc32 {_crc32(arr):#010x} != recorded "
                       f"{crcs[k]:#010x}")
        return arr
    with ThreadPoolExecutor(_THREADS) as pool:
        arrays = dict(zip(files, pool.map(load, files)))
    return arrays, meta.get("ext_dtypes", {})


def restore(ckpt_dir: str, tree_like, *,
            step: Optional[int] = None) -> Tuple[dict, int]:
    """Restore a checkpoint with the keys of `tree_like` (its values are
    ignored). Returns `(tree, step)`: every leaf a numpy array, or a CPU
    tensor for an extended dtype.

    With `step=None` (auto-resume) the newest intact checkpoint wins:
    corrupt ones (failed `verify`) are skipped newest first, and the
    last `CheckpointCorrupt` is re-raised only when every step is
    damaged. An explicit `step` never falls back: damage raises."""
    if step is None:
        steps = sorted(all_steps(ckpt_dir), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        last_err: Optional[CheckpointCorrupt] = None
        for s in steps:
            try:
                data, dtypes = verify(ckpt_dir, s)
                step = s
                break
            except CheckpointCorrupt as e:
                last_err = e
        else:
            raise last_err
    else:
        data, dtypes = verify(ckpt_dir, step)
    keys = list(_flatten(tree_like))
    if set(keys) != set(data):
        raise ValueError(f"checkpoint/tree structure mismatch: "
                         f"{sorted(set(keys) ^ set(data))}")
    return {k: _decode(data[k], k, dtypes) for k in keys}, step
