"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu -ldl

The library name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Builds land in
``build/kernels/`` beside the package (listed in ``.gitignore``) and are
written to a temporary name first, then renamed, so concurrent processes never
load a half-written file.  Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
NVCC_LIBS = ["-ldl"]  # after the source: the readout looks up libcuda's tensor-map encoder with dlsym

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS + NVCC_LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


class _Build:
    """One running nvcc: compiles ``csrc/<name>.cu`` to a temporary file."""

    def __init__(self, name: str, verbose: bool):
        self.name, self.verbose = name, verbose
        self.out = _lib_path(name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(self.tmp), str(CSRC / f"{name}.cu"), *NVCC_LIBS]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(self) -> None:
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.name}.cu:\n{log}")
        if self.verbose and log.strip():
            print(log.strip())
        os.replace(self.tmp, self.out)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def build_all(verbose: bool = False) -> List[str]:
    """Compile every source that has no up-to-date library, one nvcc per source,
    all started together.  Returns the names built or found."""
    names = sources()
    with _lock:
        builds = [_Build(n, verbose) for n in names if not _lib_path(n).exists()]
        try:
            for b in builds:
                b.finish()
        finally:
            for b in builds:
                b.kill()
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            path = _lib_path(name)
            if not path.exists():
                _Build(name, verbose=False).finish()
            _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]


def error_string(name: str, code: int) -> str:
    """cudaGetErrorString(code), through the library of ``csrc/<name>.cu``."""
    fn = load(name).kernel_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()
