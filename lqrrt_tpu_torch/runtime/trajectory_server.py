"""ctypes binding and build of the native trajectory server (port of
lqrrt_tpu/runtime/trajectory_server.py, with its own copy of the C
source, ``native/trajserver.c``).

``TrajectoryServer`` holds the committed plan in a C seqlock double buffer,
so controller threads query ``get_state``/``get_effort`` without locks and
without the GIL at control rate while the planner republishes at replan
rate.  ``attach(planner)`` publishes every plan through the planner's
``on_replan`` hook.

The shared library is compiled at first use with the host's C compiler
into ``lqrrt_tpu_torch/_build/``, under a name that carries a hash of the
source, so a stale build is never loaded; the build writes a temporary
file and renames it, so processes that build at once do not collide.
Without a C compiler, ``NativeUnavailable`` is raised, and
``Planner.get_state``/``get_effort`` remain the Python query path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "trajserver.c"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libtrajserver_{h}.so"


def _build_so(so: Path) -> Path:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        for cc in ("cc", "gcc", "clang"):
            try:
                subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", tmp,
                                str(_SRC)], check=True, capture_output=True)
            except (FileNotFoundError, subprocess.CalledProcessError):
                continue
            os.replace(tmp, so)
            return so
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    raise NativeUnavailable("no working C compiler for trajserver.c")


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not so.exists():
            _build_so(so)
        lib = ctypes.CDLL(str(so))
        lib.ts_new.restype = ctypes.c_void_p
        lib.ts_new.argtypes = [ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32]
        lib.ts_free.restype = None
        lib.ts_free.argtypes = [ctypes.c_void_p]
        lib.ts_publish.restype = ctypes.c_int
        lib.ts_publish.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.c_double]
        for fn in (lib.ts_state, lib.ts_effort):
            fn.restype = ctypes.c_ulong
            fn.argtypes = [ctypes.c_void_p, ctypes.c_double,
                           ctypes.c_void_p]
        lib.ts_duration.restype = ctypes.c_double
        lib.ts_duration.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class TrajectoryServer:
    """Single-publisher / many-reader plan store: linear interpolation of
    states and efforts with endpoint hold, as ``Planner.get_state`` and
    ``get_effort``."""

    def __init__(self, nstates: int, ncontrols: int, cap_steps: int = 8192):
        self._lib = _load()
        self.nstates = int(nstates)
        self.ncontrols = int(ncontrols)
        self.cap_steps = int(cap_steps)
        self._h = self._lib.ts_new(self.cap_steps, self.nstates,
                                   self.ncontrols)
        if not self._h:
            raise MemoryError("ts_new failed")

    def publish(self, x_seq, u_seq, dt: float):
        x = np.ascontiguousarray(x_seq, np.float32)
        u = np.ascontiguousarray(u_seq, np.float32)
        P = len(x)
        if x.shape != (P, self.nstates) or u.shape[0] not in (P - 1, 0) or (
                u.shape[0] and u.shape[1:] != (self.ncontrols,)):
            raise ValueError(f"bad plan shapes {x.shape} {u.shape}")
        rc = self._lib.ts_publish(
            self._h, x.ctypes.data_as(ctypes.c_void_p),
            u.ctypes.data_as(ctypes.c_void_p), P, float(dt))
        if rc != 0:
            raise ValueError(f"plan of {P} steps exceeds capacity "
                             f"{self.cap_steps}")

    def get_state(self, t: float) -> np.ndarray:
        out = np.empty(self.nstates, np.float32)
        v = self._lib.ts_state(self._h, float(t),
                               out.ctypes.data_as(ctypes.c_void_p))
        if v == 0:
            raise RuntimeError("no plan published")
        return out

    def get_effort(self, t: float) -> np.ndarray:
        out = np.empty(self.ncontrols, np.float32)
        v = self._lib.ts_effort(self._h, float(t),
                                out.ctypes.data_as(ctypes.c_void_p))
        if v == 0:
            raise RuntimeError("no plan published")
        return out

    @property
    def T(self) -> float:
        return float(self._lib.ts_duration(self._h))

    def attach(self, planner):
        """Publish every committed plan (composes with any existing
        ``on_replan`` hook, e.g. a metrics sink)."""
        prev = planner.on_replan

        def hook(stats):
            self.publish(planner.x_seq, planner.u_seq, planner.dt)
            if prev is not None:
                prev(stats)

        planner.on_replan = hook
        if planner.x_seq is not None:
            self.publish(planner.x_seq, planner.u_seq, planner.dt)
        return self

    def __del__(self):
        h, lib = getattr(self, "_h", None), getattr(self, "_lib", None)
        if h and lib:
            lib.ts_free(h)
            self._h = None
