"""Build, load and launch the port's hand-written CUDA kernels.

Each source in ``repro_torch/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, under ``build/`` at
the root of the checkout (the file name carries a hash of the source and
flags, so an edited source is rebuilt).  The library is loaded with
``ctypes``; every pointer and the stream cross as ``c_void_p``.  Each C entry
point launches on the stream it is given, allocates nothing, does not
synchronise, and returns ``cudaGetLastError()``; a non-zero code raises here.
``CudaKernel.launch`` makes the inputs' device current around the call and
passes that device's current stream, so the launch, its attribute calls
(``cudaFuncSetAttribute``) and the SM count it sizes by are that card's,
whichever device was current before.

Nothing is built when a module is imported: the first launch builds its
kernel, and ``build_all`` builds several in parallel (one ``nvcc`` each).
There is no fallback: without ``nvcc``, or when a build fails, the call
raises.

This replaces the JAX package's ``kernels/ops.py`` dispatch: where that
chose Pallas interpret mode or compilation, a wrapper here runs its plain
PyTorch version for CPU tensors and its kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


class CudaKernel:
    """One CUDA source, its C entry point, and its launch count.

    ``launches`` counts successful launches of the kernel and nothing else;
    callers that want a window's count set it to 0 first.
    """

    def __init__(self, source: str, entry: str, argtypes: Sequence,
                 flags: Iterable[str] = ()):
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.flags = tuple(flags)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._err = None

    @property
    def name(self) -> str:
        return self.source.stem

    def lib_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes())
        for dep in sorted(CSRC.glob("*.cuh")):
            digest.update(dep.read_bytes())
        digest.update(" ".join(NVCC_FLAGS + self.flags).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:12]}.so"

    def _command(self, out: Path) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, *self.flags, "-o", str(out),
                str(self.source)]

    def start_build(self) -> Optional[Tuple[subprocess.Popen, Path]]:
        """Start ``nvcc`` for this source unless its library exists; returns
        the process and the temporary output it writes."""
        lib = self.lib_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(self._command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), tmp

    def finish_build(self, build: Optional[Tuple[subprocess.Popen, Path]]) -> None:
        """Wait for ``start_build``'s nvcc and move its library into place."""
        if build is None:
            return
        proc, tmp = build
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, self.lib_path())

    def load(self):
        """The C entry point, building the library first if needed."""
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.lib_path()))
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.repro_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch the kernel on ``device`` (the inputs' card), made current
        for the call, on its current stream (the entry point's last
        argument); raise on a non-zero ``cudaGetLastError()``."""
        fn = self.load()
        with torch.cuda.device(device):
            code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if code != 0:
            msg = self._err(code).decode()
            raise RuntimeError(f"{self.name}: kernel launch failed with "
                               f"CUDA error {code} ({msg})")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Build every kernel's library in parallel and load each; returns the
    wall seconds per kernel (0 for a library that was already built)."""
    kernels = list(kernels)
    t0 = time.perf_counter()
    builds = [(k, k.start_build()) for k in kernels]
    secs = {}
    for k, build in builds:
        k.finish_build(build)
        secs[k.name] = 0.0 if build is None else time.perf_counter() - t0
        k.load()
    return secs


VOIDP, INT = ctypes.c_void_p, ctypes.c_int
