"""Build the hand-written sources of the package and load them with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel) and each ``native/<name>.cpp`` (host
code) exposes a plain C interface and is compiled on first use into its own
shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu -ldl
    g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off \
         -o build/native/<name>-<hash>.so native/<name>.cpp

The library name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Builds land in
``build/`` beside the package (listed in ``.gitignore``) and are written to a
temporary name first, then renamed, so concurrent processes never load a
half-written file.  A failed build raises.  Nothing is built or loaded at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Tuple

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
NATIVE = PKG / "native"
BUILD_ROOT = PKG.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
NVCC_LIBS = ["-ldl"]  # after the source: the readout looks up libcuda's tensor-map encoder with dlsym
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]

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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host geometry is built with the system's C++ compiler")


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _recipe(name: str) -> Tuple[Path, Callable[[], str], List[str], List[str], Path]:
    """(source, compiler lookup, flags, libraries after the source, build directory)
    of ``name``: ``csrc/<name>.cu`` with nvcc, else ``native/<name>.cpp`` with g++."""
    cu = CSRC / f"{name}.cu"
    if cu.exists():
        return cu, _nvcc, NVCC_FLAGS, NVCC_LIBS, BUILD_ROOT / "kernels"
    cpp = NATIVE / f"{name}.cpp"
    if cpp.exists():
        return cpp, _gxx, GXX_FLAGS, [], BUILD_ROOT / "native"
    raise ValueError(f"no source named {name!r} in csrc/ or native/")


def _lib_path(name: str) -> Path:
    src, _, flags, libs, build_dir = _recipe(name)
    h = hashlib.sha256(src.read_bytes() + " ".join(flags + libs).encode()).hexdigest()[:16]
    return build_dir / f"{name}-{h}.so"


class _Build:
    """One running compiler: builds the source of ``name`` to a temporary file."""

    def __init__(self, name: str, verbose: bool):
        src, compiler, flags, libs, build_dir = _recipe(name)
        self.src, self.verbose = src, verbose
        self.out = _lib_path(name)
        build_dir.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.with_suffix(f".{os.getpid()}.tmp")
        ptxas = ["-Xptxas", "-v"] if verbose and src.suffix == ".cu" else []
        cmd = [compiler(), *flags, *ptxas, "-o", str(self.tmp), str(src), *libs]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(self) -> None:
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"{Path(self.proc.args[0]).name} failed for {self.src.name}:\n{log}")
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
    """The loaded library for ``csrc/<name>.cu`` or ``native/<name>.cpp``,
    building it on first use."""
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
