"""Checkpoint and resume: chain state as one flat-array bundle —
counterpart of ``stark_tpu/checkpoint.py``, in the same file format.

A checkpoint is a dict of numpy arrays plus a JSON metadata dict, written
as ONE ``.npz`` (the metadata rides inside it as a uint8 array) with one
atomic rename, so a write cut off mid-way can never pair new arrays with
stale metadata.  Each package loads the other's files.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

_META_KEY = "__stark_meta_json__"


def _fsync_dir(directory: str) -> None:
    """fsync the directory entry so a rename survives power loss (the file
    fsync alone pins the bytes, not the name).  Best-effort: some
    filesystems refuse directory fds."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def rank_path(path: Optional[str]) -> Optional[str]:
    """Per-process variant of a state-file path.  The port runs one
    process on one card, so this is the identity; per-rank paths of a
    multi-process run arrive with multi-GPU (ROADMAP A11)."""
    return path


def save_checkpoint(path: str, arrays: Dict[str, np.ndarray], meta: Dict[str, Any]) -> None:
    """Atomically write arrays + meta as one .npz: write a temp file,
    fsync it, rename it over ``path``, fsync the directory.  Without the
    fsync pair the rename can land while the temp file's pages are still
    dirty, leaving the named checkpoint truncated after a crash."""
    if _META_KEY in arrays:
        raise ValueError(f"array name {_META_KEY!r} is reserved")
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(directory)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """-> (arrays, meta); meta is {} for a file without one."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
        meta: Dict[str, Any] = {}
        if _META_KEY in z.files:
            meta = json.loads(bytes(z[_META_KEY]).decode("utf-8"))
    return arrays, meta
