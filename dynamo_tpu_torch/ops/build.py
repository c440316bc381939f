"""Build the CUDA kernels from ``ops/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a``. Libraries land in a build directory keyed by a
hash of the source, the ``csrc/*.cuh`` headers it includes and the flags,
so an edited source or header rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them; :func:`library` builds on first use.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

from ..runtime.config import env_str

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# --split-compile 0: each nvcc spreads its source's device-code
# optimisation over every core (the attention sources hold ~30 kernel
# instantiations each, the longest build)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v", "--split-compile", "0"]

_INCLUDE = re.compile(r'^#include "([^"]+\.cuh)"', re.MULTILINE)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output per source (register and shared-memory use from -Xptxas -v)
BUILD_LOG: Dict[str, str] = {}


def build_dir() -> str:
    return env_str("DYN_TORCH_KERNEL_BUILD_DIR") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_build")


def nvcc() -> str:
    path = env_str("DYN_TORCH_NVCC") or shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU (set DYN_TORCH_NVCC)")
    return path


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _headers(src: bytes) -> List[str]:
    """The csrc headers a source includes, directly or through another
    csrc header, sorted."""
    seen, todo = set(), set(_INCLUDE.findall(src.decode()))
    while todo:
        header = todo.pop()
        seen.add(header)
        with open(os.path.join(CSRC, header)) as f:
            todo |= set(_INCLUDE.findall(f.read())) - seen
    return sorted(seen)


def _target(name: str) -> str:
    """The library's path, named by a hash of its source, the csrc headers
    it includes (:func:`_headers`), and the flags."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    for header in _headers(src):
        with open(os.path.join(CSRC, header), "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    return subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    target = _target(name)
    os.replace(f"{target}.{os.getpid()}.tmp", target)


def build_all() -> List[str]:
    """Compile every source that has no up-to-date library, one nvcc per
    source in parallel. Returns the names built or found."""
    names = sources()
    with _lock:
        procs = {n: _start(n) for n in names}
        for n, p in procs.items():
            _finish(n, p)
    return names


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                _finish(name, _start(name))
                lib = ctypes.CDLL(_target(name))
                _libs[name] = lib
    return lib
