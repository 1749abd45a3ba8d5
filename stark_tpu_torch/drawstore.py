"""Append-only posterior-draw store — counterpart of
``stark_tpu/drawstore.py``, in the same ``.stkr`` file format.

The writer is the C++ library ``native/drawstore.cpp`` (the port's own
copy), built with ``g++`` at first use by `_build.host_library` and
called through ``ctypes``; ``append`` hands a block to its writer thread
and returns.  Reading is plain numpy.  See the C++ source for the format.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from . import _build

_HEADER_BYTES = 4 + 4 + 8 + 8  # magic, version, chains, dim

_API = {
    "ds_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]),
    "ds_append": (ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64]),
    "ds_flush": (ctypes.c_int, [ctypes.c_void_p]),
    "ds_count": (ctypes.c_uint64, [ctypes.c_void_p]),
    "ds_close": (ctypes.c_int, [ctypes.c_void_p]),
}


def _load() -> ctypes.CDLL:
    lib = _build.host_library("drawstore")
    for name, (restype, argtypes) in _API.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib


class DrawStore:
    """Append-only draw sink; ``append`` does not wait for the disk."""

    def __init__(self, path: str, chains: int, dim: int):
        self._lib = _load()
        self._handle = self._lib.ds_open(path.encode(), ctypes.c_uint64(chains), ctypes.c_uint64(dim))
        if not self._handle:
            raise OSError(f"DrawStore: cannot open {path!r}")
        self.path = path
        self.chains = chains
        self.dim = dim

    def append(self, block: np.ndarray, *, draw_major: bool = False) -> None:
        """Append one block: (chains, n_draws, dim) by default, transposed
        here to the draw-major order on disk; ``draw_major=True`` takes a
        block already laid out (n_draws, chains, dim) — the ensemble
        sampler's — and hands it over without the transpose."""
        c_ax = 1 if draw_major else 0
        if block.ndim != 3 or block.shape[c_ax] != self.chains or block.shape[2] != self.dim:
            raise ValueError(
                f"expected (chains={self.chains}, n, dim={self.dim})"
                f"{' draw-major' if draw_major else ''}, got {block.shape}"
            )
        if not draw_major:
            block = np.transpose(block, (1, 0, 2))
        block = np.ascontiguousarray(block, np.float32)
        rc = self._lib.ds_append(
            self._handle,
            block.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_uint64(block.shape[0]),
        )
        if rc != 0:
            raise OSError(f"DrawStore.append failed: rc={rc}")

    def flush(self) -> None:
        """Wait until every appended draw is on disk."""
        rc = self._lib.ds_flush(self._handle)
        if rc != 0:
            raise OSError(f"DrawStore.flush failed: rc={rc}")

    def __len__(self) -> int:
        return int(self._lib.ds_count(self._handle))

    def close(self) -> None:
        if self._handle:
            rc = self._lib.ds_close(self._handle)
            self._handle = None
            if rc != 0:
                raise OSError(f"DrawStore.close failed: rc={rc}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_header(path: str) -> Tuple[int, int]:
    """Validate the STKD header; -> (chains, dim)."""
    with open(path, "rb") as f:
        header = f.read(_HEADER_BYTES)
    if header[:4] != b"STKD":
        raise ValueError(f"{path!r} is not a DrawStore file")
    chains = int.from_bytes(header[8:16], "little")
    dim = int.from_bytes(header[16:24], "little")
    return chains, dim


def truncate_draws(path: str, n_draws: int) -> None:
    """Cut the store to its first ``n_draws`` rows (never extend it).

    Resume reconciliation: the async writer can land a block before the
    matching checkpoint is renamed into place, so on resume the store may
    hold rows no checkpoint accounts for; re-running that block would
    count them twice.
    """
    chains, dim = _read_header(path)
    target = _HEADER_BYTES + 4 * chains * dim * n_draws
    if os.path.getsize(path) > target:
        os.truncate(path, target)


def read_draws(path: str, mmap: bool = True) -> Tuple[np.ndarray, int, int]:
    """-> (draws (n, chains, dim), chains, dim); a read-only memmap by
    default.  A store torn mid-row (a crash, a full disk, a reader racing
    the writer) reads as its complete rows, on both paths; one torn
    inside its first row reads as zero draws."""
    chains, dim = _read_header(path)
    size = os.path.getsize(path) - _HEADER_BYTES
    n = max(size, 0) // (4 * chains * dim)
    if n == 0:
        return np.empty((0, chains, dim), np.float32), chains, dim
    if mmap:
        arr = np.memmap(path, np.float32, mode="r", offset=_HEADER_BYTES, shape=(n, chains, dim))
    else:
        with open(path, "rb") as f:
            f.seek(_HEADER_BYTES)
            arr = np.fromfile(f, np.float32, count=n * chains * dim)
        arr = arr.reshape(n, chains, dim)
    return arr, chains, dim
