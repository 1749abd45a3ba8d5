"""Build and load the CUDA kernels in ``stark_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is one shared library with a plain C interface,
compiled at first use with::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/stark_tpu_torch/lib<name>-<hash>.so

and loaded with ``ctypes``.  The file name carries a hash of the sources
and flags, so an edited kernel is rebuilt and a stale library is never
loaded.  Sources come from the checkout only.  A failed build raises.
Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "stark_tpu_torch"

#: every kernel library of the package, one per source file
SOURCES = ("hier_grouped", "lmm_grouped", "logistic_batched", "logistic_single")

_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> loaded library, per process
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built from csrc/ with nvcc on the machine with the card"
        )
    return found


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named library that is not built yet, all ``nvcc``
    processes started together.  Returns name -> compiler log (the
    ``-Xptxas -v`` register/shared-memory/spill report); raises on the
    first failed build."""
    names = list(names)
    for n in names:
        if n not in SOURCES:
            raise ValueError(f"unknown kernel library {n!r}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    logs: Dict[str, str] = {}
    for n in names:
        out = _target(n)
        if out.exists():
            logs[n] = "(already built)"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd: List[str] = [_nvcc(), *_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for n, out, tmp, p in procs:
        text, _ = p.communicate()
        logs[n] = text
        if p.returncode != 0:
            failed.append(f"nvcc failed for csrc/{n}.cu (exit {p.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def function(lib: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``lib`` (built and loaded
    at first use), typed with ``argtypes`` and an int (cudaError_t)
    return."""
    if lib not in _LIBS:
        build([lib])
        _LIBS[lib] = ctypes.CDLL(str(_target(lib)))
    fn = getattr(_LIBS[lib], symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(lib: str, err: int) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = function(lib, "stark_error_string", [ctypes.c_int])
        msg.restype = ctypes.c_char_p
        raise RuntimeError(
            f"CUDA kernel in csrc/{lib}.cu failed: "
            f"{msg(err).decode()} (cudaError_t {err})"
        )
