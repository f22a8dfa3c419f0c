"""Build and bind the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, at first use, from the sources in
this checkout only, and loaded with ctypes. The library lands in
`build/strawberry_tpu_torch/` under the repository root (gitignored), named
by a hash of its source and flags, so an edited source rebuilds and a
stale library is never loaded. Nothing here runs when the module is
imported: the CPU tests import every module and have no `nvcc`.
"""
from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess
import threading
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "strawberry_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, C.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if not CUDA_HOME:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "port's kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str):
    """(source path, library path) of csrc/<name>.cu; the library's name
    carries a hash of the source and the flags."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names) -> Dict[str, str]:
    """Compile csrc/<name>.cu for every name whose library for this exact
    source and these flags does not exist, one nvcc process per source,
    all started together; return {name: library path}."""
    libs, procs = {}, []
    for name in names:
        src, lib = libs[name] = _target(name)
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs.append((src, lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, lib, tmp, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src}:\n{err}")
        else:
            os.replace(tmp, lib)  # atomic: no one sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: lib for name, (_src, lib) in libs.items()}


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless the library for this exact source and
    these flags exists; return the library's path."""
    return build_all([name])[name]


def load(name: str) -> C.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = C.CDLL(build(name))
            lib.strawb_cuda_error_string.restype = C.c_char_p
            lib.strawb_cuda_error_string.argtypes = [C.c_int]
            _libs[name] = lib
        return lib


def check(lib: C.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point (a refused
    launch never runs, and a later synchronize does not report it)."""
    if err:
        msg = lib.strawb_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


# PyTorch's C call for the current stream's raw handle, where it has one
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(device_index: int) -> int:
    """The cudaStream_t of PyTorch's current stream on a GPU, as an int:
    the raw handle straight from PyTorch's C layer where it has the call
    (no Python Stream object), else through torch.cuda.current_stream."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


class Entry:
    """One C entry point of csrc/<name>.cu that returns a cudaError_t,
    bound once: the first call builds and loads the library and sets the
    function's prototype, every later call goes straight to ctypes with no
    lock and no prototype to set. A nonzero return raises RuntimeError.

        launch = Entry("shard_reduce", "strawb_shard_colsum",
                       [C.c_void_p, C.c_int, ...])
        launch(rows.data_ptr(), N, ...)
    """

    def __init__(self, name: str, symbol: str, argtypes):
        self.name, self.symbol, self.argtypes = name, symbol, list(argtypes)
        self._lib = self._fn = None

    def _bind(self):
        """The bound ctypes function (built and loaded on first use)."""
        if self._fn is None:
            lib = load(self.name)
            fn = getattr(lib, self.symbol)
            fn.restype = C.c_int
            fn.argtypes = self.argtypes
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, *args) -> None:
        fn = self._fn or self._bind()
        err = fn(*args)
        if err:
            check(self._lib, err, self.symbol)
