"""Build and load the package's CUDA kernels (no JAX counterpart).

Every ``csrc/*.cu`` file is compiled at first use for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, which is loaded
with ``ctypes``.  The library's name carries a hash of the sources and
flags, so a stale build is never loaded.  The build goes to
``lqrrt_tpu_torch/_build/`` (git-ignored) and takes seconds, since no source
includes PyTorch's headers.  What ``ptxas -v`` said of each kernel
(registers, shared memory, spills) is kept beside the library, in
``ptxas_log_path()``.

Each C entry point launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; ``check`` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: pointers and the stream as c_void_p, sizes as c_int, scalars
# as c_float
_SIGNATURES = {
    "lqrrt_nn_const": [_P] * 8 + [_I, _I, _I, _I, _P],
    "lqrrt_nn_general": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "lqrrt_block_write": [_P, _P, _P, _I, _I, _I, _P],
    "lqrrt_nn_expand": [_P] * 8 + [_I, _I, _I, _I, _I, _P],
    "lqrrt_steer_rollout": [_P, _P, _P, _I, _P, _P, _I] + [_P] * 4 + [_I]
                           + [_P] * 2 + [_I, _I, _F, _F, _F] + [_P] * 6
                           + [_I, _I, _I, _F, _F, _F, _I, _I, _I, _P],
    "lqrrt_math_probe": [_P, _P, _P, _I, _I, _P],
    "lqrrt_steer_stage": [_P, _P, _P, _I, _P, _P, _I] + [_P] * 5
                         + [_I, _I, _F, _F, _F, _I, _I, _P],
    "lqrrt_scaffold_probe": [_P, _P, _P] + [_I] * 8 + [_P],
}

_lib = None


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblqrrt_kernels_{h.hexdigest()[:16]}.so"


def ptxas_log_path() -> Path:
    return library_path().with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile the kernels unless a library for these exact sources
    exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [s for s in _sources() if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in cu]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", str(s), "-o", o]
                for s, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        for cmd, p, log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        tmp_out = Path(tmp) / out.name
        cmd = [_nvcc(), *ARCH, "-shared", "-o", str(tmp_out), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        ptxas_log_path().write_text("".join(logs))
        os.replace(tmp_out, out)   # atomic: never a half-written library
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
