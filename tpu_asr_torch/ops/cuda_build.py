"""Build and load the port's CUDA kernels.

Each source under tpu_asr_torch/csrc/ has a plain C interface. At first
use it is compiled by nvcc for Hopper (sm_90a) into a shared library in
tpu_asr_torch/_build/ (ignored by git), named by a hash of its source and
flags so an edited source is rebuilt, and loaded with ctypes. Nothing is
built when a module is imported; a failed build raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def check_tensor(name: str, x, shape: tuple, dtype, device) -> None:
    """Raise unless x is a contiguous `dtype` tensor of `shape` on
    `device`: what a kernel's wrapper checks before passing a pointer."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"     # the toolkit's standard prefix
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's CUDA kernels need it")


class KernelLibrary:
    """One csrc/<name>.cu source, built once per process at first use."""

    def __init__(self, name: str):
        self.name = name
        self.source = os.path.join(CSRC_DIR, f"{name}.cu")
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        self.build_log = ""                       # nvcc's -Xptxas -v report

    def _target(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{digest.hexdigest()[:16]}.so")

    def _build(self, target: str) -> None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed on {self.source} (rc {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, target)    # atomic: other processes see all or
        finally:                       # nothing of the library
            if os.path.exists(tmp):
                os.remove(tmp)
        self.build_log = proc.stdout + proc.stderr

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                target = self._target()
                if not os.path.exists(target):
                    self._build(target)
                self._lib = ctypes.CDLL(target)
            return self._lib


def load_all(*libraries: KernelLibrary) -> None:
    """Build (one nvcc per source, all at once) and load the libraries;
    raises the first build error."""
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        for future in [pool.submit(lib.load) for lib in libraries]:
            future.result()
