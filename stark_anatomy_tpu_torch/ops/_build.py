"""Build and load the CUDA kernels (csrc/*.cu) and count their launches.

The sources are compiled at FIRST LAUNCH, never at import: one ``nvcc``
process per source file, all started together, for ``sm_90a``, linked into
one shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds). The library lands in the
package's ``_build/`` directory (git-ignored) under a name that includes a
hash of the sources, so a stale build is never loaded. A build failure
raises with the compiler's output; nothing falls back.

Every kernel wrapper calls ``launch(name, *args)``, which passes PyTorch's
current stream, raises on a non-zero ``cudaGetLastError()`` and adds one to
the kernel's entry in ``LAUNCHES``: the record that a run really went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("field.cu", "inv.cu", "ntt.cu", "blake2b.cu", "zk.cu", "trace_layout.cu")
HEADERS = ("field.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_p, _l, _i, _u = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_uint32
_FP_BINARY = [_p, _l, _p, _l, _u, _u, _u, _u, _p, _l, _l, _p]
#: C entry -> argtypes (the trailing c_void_p is the stream).
SIGNATURES = {
    "fp_add": _FP_BINARY,
    "fp_sub": _FP_BINARY,
    "fp_mont_mul": _FP_BINARY,
    "fp_butterfly": [_p, _l, _p, _l, _p, _l, _u, _u, _u, _u, _p, _l, _p, _l, _l, _p],
    "fp_pow_const": [_p, _l, _u, _u, _u, _u, _p, _l, _l, _p],
    "fp_batch_inv": [_p, _l, _l, _p, _l, _p, _l, _i, _p],
    "ntt_block": [_p, _l, _p, _l, _p, _l, _i, _i, _i, _i, _i, _u, _u, _u, _u, _p],
    "ntt_stage": [_p, _l, _p, _l, _i, _i, _i, _i, _i, _p],
    "ntt_grouped": [_p, _l, _p, _l, _p, _l, _l, _i, _i, _u, _u, _u, _u, _p],
    "blake2b_planes": [_p, _l, _i, _i, _p, _l, _l, _p],
    "zk_coefficients": [_u, _u, _l, _l, _p, _l, _p, _l, _p],
    "trace_layout": [_p, _l, _i, _p, _l, _p, _l, _l, _p],
}

#: launches per kernel since the last reset_launch_counts().
LAUNCHES = {name: 0 for name in SIGNATURES}

_lib = None
build_seconds = None  # wall time of the build this process did (None: none)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile csrc/ into _build/ (if not already there); returns the path."""
    global build_seconds
    lib_path = os.path.join(BUILD_DIR, f"libstark_kernels_{_source_hash()}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for name in SOURCES:
        obj = os.path.join(BUILD_DIR, name + f".{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", CSRC, "-c", os.path.join(CSRC, name), "-o", obj]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, log = [], []
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        objs.append(obj)
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print("".join(log))
    return lib_path


def load(verbose: bool = False):
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build(verbose))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Launch C entry `name` on the current stream; raise if it was refused."""
    fn = getattr(load(), name)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {rc})")
    LAUNCHES[name] += 1


def check_planes(x: torch.Tensor, planes: int | None, what: str) -> None:
    """A kernel operand: 2-D int32 (planes, n), unit stride along n."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError(f"{what}: expected an int32 tensor, got {getattr(x, 'dtype', type(x))}")
    if x.dim() != 2 or (planes is not None and x.shape[0] != planes):
        raise ValueError(f"{what}: expected shape ({planes or 'k'}, n), got {tuple(x.shape)}")
    if x.shape[1] < 1:
        raise ValueError(f"{what}: empty batch")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(
            f"{what}: elements of a plane must be contiguous (stride {x.stride(1)}); "
            "call .contiguous() first"
        )
