"""Build and load the port's CUDA kernels (regtr_tpu_torch/csrc/*.cu).

Each source has a plain C interface.  nvcc compiles it for sm_90a at first
use into `.build/` at the root of the checkout, into a shared library named
by a hash of its source, the headers beside it (csrc/*.cuh) and the flags
(a changed source or header is rebuilt), which is loaded with ctypes.  Every C entry point returns the CUDA error of its
launch; `check` turns a non-zero one into an exception.  `build_all`
starts one nvcc per source at once, so a cold start waits for the slowest
source only; `kernel_libraries` lists every source of the port.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Sequence

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / ".build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


class CudaLibrary:
    """One kernel source, its build and its ctypes handle.

    `declare(lib)` sets the argtypes/restype of the source's entry points.
    """

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._declare = declare

    def path(self) -> Path:
        """Where the built library lives: named by a hash of the source,
        every header in its directory and the flags."""
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            digest.update(header.name.encode() + header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}_{digest.hexdigest()[:16]}.so"

    def _start(self):
        """Start nvcc if the library is missing: (process, temp path) or
        None.  Its output (ptxas registers and spills) goes to a `.log`
        file beside the library."""
        if self.path().exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        try:
            out = proc.communicate()[0]
            self.path().with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{self.source}:\n{out}")
            os.replace(tmp, self.path())
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def build(self) -> Path:
        """Compile the library if it is missing; raise if nvcc fails."""
        self._finish(self._start())
        return self.path()

    def load(self) -> ctypes.CDLL:
        return _load(self)

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            msg = self.load().regtr_cuda_error_string(err).decode()
            raise RuntimeError(f"{what} launch failed: {msg}")


@functools.lru_cache(maxsize=None)
def _load(library: CudaLibrary) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library.build()))
    library._declare(lib)
    lib.regtr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.regtr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_all(libraries: Sequence[CudaLibrary]) -> None:
    """Build every missing library, one nvcc process per source, all at
    once; raise after all have ended if any failed."""
    started = [(lib, lib._start()) for lib in libraries]
    errors = []
    for lib, s in started:
        try:
            lib._finish(s)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def kernel_libraries() -> list:
    """Every kernel library of the port: K1, K2/K3, K4, K5, K6 and
    GeoTransformer's geometric embedding."""
    from . import attention, gather, geo_embedding, kpconv, neighbors

    return [attention.FWD_LIBRARY, attention.BWD_LIBRARY,
            kpconv.SEGSUM_LIBRARY, gather.GATHER_LIBRARY,
            neighbors.NEIGHBORS_LIBRARY, geo_embedding.GEO_LIBRARY]
