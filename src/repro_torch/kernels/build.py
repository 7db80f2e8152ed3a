"""Builds the port's CUDA sources (``repro_torch/csrc/*.cu``) with nvcc into
shared libraries with a plain C interface, loaded through ctypes.

Each library is named after a hash of its source and of the headers
(``csrc/*.cuh``) the source includes, so an edited source or header is
rebuilt on its next use and a stale library is never loaded.  Builds go to
``build/repro_torch_kernels/`` at the root of the checkout and happen at
first use, never at import.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Dict, Iterable, Iterator

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Counts a kernel's launches, so a run can show that its main path
    went through the kernel.  The wrapper adds one where it launches.

    Under a CUDA graph capture a wrapper's call records a launch that has
    not run: ``capture_launches`` takes those back and hands them to the
    graph, which adds them again on every replay."""

    _all: "weakref.WeakSet[LaunchCounter]" = weakref.WeakSet()

    def __init__(self):
        self.count = 0
        LaunchCounter._all.add(self)


class GraphLaunches:
    """The launches a CUDA graph recorded, per counter."""

    def __init__(self):
        self.per_counter: Dict[LaunchCounter, int] = {}

    def replayed(self) -> None:
        """Count one replay of the graph: every recorded launch ran again."""
        for counter, n in self.per_counter.items():
            counter.count += n


@contextlib.contextmanager
def capture_launches() -> Iterator[GraphLaunches]:
    """Around a CUDA graph capture: every launch counted inside is taken
    back on exit (none of them ran) and recorded in the yielded
    ``GraphLaunches``, whose ``replayed()`` the graph's owner calls on
    each replay."""
    before = {c: c.count for c in list(LaunchCounter._all)}
    recorded = GraphLaunches()
    try:
        yield recorded
    finally:
        for counter, n in before.items():
            if counter.count != n:
                recorded.per_counter[counter] = counter.count - n
                counter.count = n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for header in sorted(set(re.findall(rb'#include "(\w+\.cuh)"', src))):
        h.update((CSRC / header.decode()).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every source in ``names`` that has no library yet, one nvcc
    process per source, all started together.  Returns each source's
    ptxas report (empty where the library was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
