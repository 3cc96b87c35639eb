"""Builds the CUDA kernels of ``graphtrans_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own shared library under
``graphtrans_tpu_torch/_build/`` (named by a hash of the source and of the
shared ``csrc/*.cuh`` headers, so an edit rebuilds), loaded with
``ctypes``. Importing this module compiles nothing.
A failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("gin_agg", "attention_packed", "flash_hil", "spmm",
           "flash_attention", "dropout", "attention_smalls",
           "transformer_layer", "dense_agg", "block_spmm", "scatter_mxu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
build_log: dict = {}  # name -> nvcc's output (registers, spills) of the build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha1((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=KERNELS) -> float:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns the wall seconds."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        build_log[n] = out
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launch returned a CUDA error (cudaGetLastError != 0)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.error_string(err).decode()}")


def align(*tensors) -> int:
    """The widest vector, in elements, that every tensor's address allows:
    4 where each is aligned to 4 of its elements (16 bytes in float32, 8 in
    bf16), else 1."""
    return 4 if all(t.data_ptr() % (4 * t.element_size()) == 0
                    for t in tensors) else 1


def entry(lib: ctypes.CDLL, name: str, dtype: torch.dtype):
    """The C entry ``name`` of a kernel's float32 instance, or for another
    ``dtype`` (bf16) ``name``_bf16, whose parameters are the f32 entry's
    (pointers and ints): typed from it at its first use."""
    if dtype == torch.float32:
        return getattr(lib, name)
    fn = getattr(lib, name + "_bf16")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = getattr(lib, name).argtypes, ctypes.c_int
    return fn
