"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``avtex_torch/csrc/<name>.cu`` exposes a plain ``extern "C"``
launcher and is compiled on its own into
``avtex_torch/_build/lib<name>-<hash>.so`` at first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>-<hash>.so <name>.cu

The hash covers the source, every header it includes from ``csrc/``
(``#include "<file>"``, followed through headers) and the flags, so an
edited source or header rebuilds. No PyTorch headers are included, which
keeps a build to seconds.
``build_all`` starts one ``nvcc`` per source, all at once, and waits.

The host runtime's C++ (``avtex_torch/native/*.cc``: the frame stitcher,
the crossfade and the AVI muxer) builds the same way into one
``avtex_torch/_build/libavtex_torch_native-<hash>.so``::

    g++ -O2 -fPIC -std=c++17 -ffp-contract=off -shared -o <lib> *.cc

``-ffp-contract=off`` keeps the crossfade's float arithmetic one rounding
per operation, as numpy's plain version rounds it (a target with fused
multiply-add would otherwise contract it). ``g++`` is called directly and
must be on ``PATH``; a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("fused_conv1x1", "pairwise_l2", "fused_stage")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

NATIVE_DIR = os.path.join(_PKG, "native")
NATIVE_SOURCES = ("framestitch.cc", "muxer.cc")
NATIVE_NAME = "avtex_torch_native"
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from avtex_torch/csrc at first use and need the "
                       "CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly
    or through another header, in the order first reached."""
    files, todo = [], [f"{name}.cu"]
    while todo:
        rel = todo.pop(0)
        if rel in files:
            continue
        files.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return files


def lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in source_files(name):
        with open(os.path.join(CSRC, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _command(name: str, out: str, verbose: bool) -> List[str]:
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    return cmd


def build_all(names=SOURCES, verbose: bool = False) -> Dict[str, dict]:
    """Build every missing library in parallel; return per-source
    ``{"seconds", "log", "cached"}``. Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    report: Dict[str, dict] = {}
    for name in names:
        final = lib_path(name)
        if os.path.exists(final):
            report[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = f"{final}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, final)
    failed = []
    for name, (proc, tmp, final) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log,
                        "cached": False}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, final)  # atomic: no process loads a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not os.path.exists(path):
            build_all((name,))
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib


def native_lib_path() -> str:
    """Where the host runtime's library goes: named by a hash of its
    sources and ``GXX_FLAGS``."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for rel in NATIVE_SOURCES:
        with open(os.path.join(NATIVE_DIR, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"lib{NATIVE_NAME}-{digest.hexdigest()[:12]}.so")


def build_native() -> dict:
    """Build the host runtime's library unless it exists; return
    ``{"seconds", "log", "cached"}``. Raises when ``g++`` is not on
    ``PATH`` or the build fails. The library is written under a name of
    this process's own and renamed into place, so processes building at
    once never load a partial file."""
    final = native_lib_path()
    if os.path.exists(final):
        return {"seconds": 0.0, "log": "", "cached": True}
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the port's host runtime "
                           "is built from avtex_torch/native/*.cc at first "
                           "use and needs a C++17 compiler")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, "-o", tmp,
         *(os.path.join(NATIVE_DIR, rel) for rel in NATIVE_SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for avtex_torch/native "
                           f"(rc={proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, final)
    return {"seconds": time.perf_counter() - t0, "log": proc.stdout,
            "cached": False}


def load_native() -> ctypes.CDLL:
    """The host runtime's library (built on first use)."""
    lib = _loaded.get(NATIVE_NAME)
    if lib is None:
        build_native()
        lib = ctypes.CDLL(native_lib_path())
        _loaded[NATIVE_NAME] = lib
    return lib
