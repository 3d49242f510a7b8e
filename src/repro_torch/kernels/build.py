"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled, on first use, into ``build/kernels/lib<name>-<hash>.so`` at the
repository root (``build/`` is git-ignored), for ``sm_90a`` only. The file
name carries the SHA-256 of the source and of the shared headers
(``csrc/*.cuh``), so an edited source or header is rebuilt and a stale
library is never loaded. ``build`` starts one ``nvcc`` per source, all at
once, and waits for them; ``load`` builds what is missing and returns the
``ctypes.CDLL``; ``sources`` names every kernel source.

Nothing here runs at import: the CPU tests import every module, and no card
or toolkit is needed until a kernel is launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from repro_torch.kernels.common import KernelError

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: the last build's log per kernel source: nvcc's command, its wall time and
#: what ``-Xptxas -v`` reported (registers, shared memory, spills)
build_logs: dict[str, str] = {}


class KernelBuildError(KernelError):
    """nvcc is missing or refused a kernel source, or its library does not
    load."""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (looked in $CUDA_HOME/bin, "
                               "/usr/local/cuda/bin and PATH)")
    return found


def sources() -> list[str]:
    """The name of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compile every source in ``names`` whose library is missing, one nvcc
    process each, all started together; returns name -> library path."""
    out = {name: library_path(name) for name in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = out[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        wall = time.perf_counter() - t0
        build_logs[name] = (f"$ {' '.join(cmd)}\n[{wall:.2f} s, rc "
                            f"{proc.returncode}]\n{log}")
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[name])     # atomic: no half-written library
    if failed:
        raise KernelBuildError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(build_logs[n] for n in failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _libs[name] = lib
        return lib
