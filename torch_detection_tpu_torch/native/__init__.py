"""Host-side C++ of the port, built with g++ at first use and loaded with ctypes.

Each ``native/<name>.cpp`` is plain C++17 with a C interface, compiled on
its own into ``build/native/<name>-<hash>.so`` under the repository root;
the hash covers the source and the flags, so an edited source is rebuilt.
Nothing is compiled when this module is imported. There is no fallback: a
missing ``g++`` or a failed build raises ``RuntimeError`` with the
compiler's log. ctypes releases the GIL for the length of each call, so
threads can decode in parallel.
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
from typing import Dict

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds each source took to build in this process
BUILD_SECONDS: Dict[str, float] = {}


def library_path(name: str) -> Path:
    h = hashlib.sha256((SRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless its library is built; returns the
    library's path."""
    target = library_path(name)
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: native/{name}.cpp is built with g++ at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC / f"{name}.cpp")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for native/{name}.cpp:\n{proc.stdout}")
    os.replace(tmp, target)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
