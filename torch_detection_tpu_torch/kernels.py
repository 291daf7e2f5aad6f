"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/kernels/<name>-<hash>.so`` under the repository root. The
hash covers the source, every header ``csrc/*.cuh`` and the flags, so an
edited source or shared header is rebuilt.
Nothing is compiled when this module is imported: ``load`` builds a library
at its first use in a process, and ``build_all`` builds every source at once,
one ``nvcc`` per source, all started together.

The target is ``sm_90a`` (Hopper). ``nvcc`` is found on ``PATH`` or under
``$CUDA_HOME/bin`` (default ``/usr/local/cuda``); without it a build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# what ptxas reported for each source built in this process (registers,
# shared memory, spills), for the build log of a chip run
BUILD_LOGS: Dict[str, str] = {}


def sources() -> List[str]:
    """Names of every CUDA source of the package."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = ()) -> Dict[str, float]:
    """Compile the named sources (default: all) in parallel; returns seconds
    per source. Sources whose library is already built are skipped."""
    names = list(names) or sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        target = _library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, target, time.perf_counter())
    seconds = {}
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
