"""Build and load the CUDA kernels in ``stark_tpu_torch/csrc`` and the
host C++ libraries in ``stark_tpu_torch/native``.

Each ``csrc/<name>.cu`` is one shared library with a plain C interface,
compiled at first use with::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/stark_tpu_torch/lib<name>-<hash>.so

and loaded with ``ctypes``.  A source listed in ``PARTS`` is compiled in
parts instead, one ``nvcc -c -DSTARK_PART=<k>`` each, all started with
the other libraries' builds, and the objects are linked into the one
library (``nvcc -shared``): the source keeps each part's kernels under
``#if`` on ``STARK_PART``, so its kernels compile side by side rather
than in turn (a source compiled whole, without ``STARK_PART``, holds
every part).  Each ``native/<name>.cpp`` (host code, such
as the draw store) is built the same way with ``g++`` alone, so it needs
no CUDA toolkit and builds on a host without a card.  The file name
carries a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded; each build writes a temporary name
of its own process and renames it into place, so processes that build
at once never load a half-written library.  Sources come from the
checkout only.  A failed build raises.  Nothing is compiled when this
module is imported.
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
NATIVE = _PKG / "native"
BUILD_DIR = _PKG.parent / "build" / "stark_tpu_torch"

#: every kernel library of the package, one per source file
SOURCES = ("hier_grouped", "lmm_grouped", "logistic_batched", "logistic_single")

_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: sources compiled in parts: name -> number of parts (csrc/<name>.cu's
#: STARK_PART values 0 .. n - 1)
PARTS = {"logistic_batched": 8}

# the flags of one part's object (PARTS): _FLAGS without -shared
_OBJ_FLAGS = tuple(f for f in _FLAGS if f != "-shared")

#: every host library of the package, one per source file in native/
HOST_SOURCES = ("drawstore",)

_HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

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
    h.update(str(PARTS.get(name, 0)).encode())
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
    procs = []  # (name, [(command's label, process)], output, temporary, objects)
    logs: Dict[str, str] = {}
    for n in names:
        out = _target(n)
        if out.exists():
            logs[n] = "(already built)"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = str(CSRC / f"{n}.cu")
        if n in PARTS:
            objs = [out.with_suffix(f".{os.getpid()}.part{k}.o") for k in range(PARTS[n])]
            cmds = [(f"part {k}", [_nvcc(), *_OBJ_FLAGS, f"-DSTARK_PART={k}", "-c", "-o",
                                   str(o), src]) for k, o in enumerate(objs)]
        else:
            objs = []
            cmds = [("", [_nvcc(), *_FLAGS, "-o", str(tmp), src])]
        procs.append((n, [(label, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )) for label, cmd in cmds], out, tmp, objs))
    failed = []
    for n, parts, out, tmp, objs in procs:
        texts, ok = [], True
        for label, p in parts:
            text, _ = p.communicate()
            texts.append(f"--- {label}\n{text}" if label else text)
            if p.returncode != 0:
                ok = False
                failed.append(f"nvcc failed for csrc/{n}.cu {label} (exit {p.returncode}):\n{text}")
        if ok and objs:
            link = subprocess.run([_nvcc(), *_FLAGS[:2], "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            texts.append(link.stdout + link.stderr)
            if link.returncode != 0:
                ok = False
                failed.append(f"linking csrc/{n}.cu's parts failed:\n{link.stdout}{link.stderr}")
        for o in objs:
            o.unlink(missing_ok=True)
        logs[n] = "\n".join(texts)
        if ok:
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


def _host_target(name: str) -> Path:
    h = hashlib.sha1(" ".join(_HOST_FLAGS).encode())
    h.update((NATIVE / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def host_library(name: str) -> ctypes.CDLL:
    """The host library ``native/<name>.cpp``, built with ``g++`` at
    first use and loaded; raises when the build fails."""
    if name not in HOST_SOURCES:
        raise ValueError(f"unknown host library {name!r}")
    key = f"native/{name}"
    if key not in _LIBS:
        out = _host_target(name)
        if not out.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found on PATH: native/{name}.cpp is built with it")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [gxx, *_HOST_FLAGS, "-o", str(tmp), str(NATIVE / f"{name}.cpp")],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed for native/{name}.cpp (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        _LIBS[key] = ctypes.CDLL(str(out))
    return _LIBS[key]
