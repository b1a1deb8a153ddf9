"""Build and load the C ABI predictor shim (``csrc/predictor_capi.cpp``),
the counterpart of ``paddle_tpu/inference/capi.py``.

Reference: fluid/inference/capi/paddle_c_api.h + go/paddle/predictor.go
-- a C surface any language with an FFI (Go, Rust, C#) can bind.  The
shim embeds CPython and drives :class:`paddle_tpu_torch.inference.
Predictor`.  :func:`load_capi` compiles it with ``g++`` at first use
into ``build/paddle_tpu_torch_capi/`` at the repository root (again
whenever the sources change) and loads it; :class:`CPredictor` is the
ctypes harness that tests it and shows the calling convention an
external program uses.

The C ABI has no device argument: the predictor goes to the current
CUDA device unless ``PADDLE_TPU_TORCH_CAPI_DEVICE=cpu`` is set in the
environment (``DEVICE_ENV``), and with no card and no such request
``PT_NewPredictor`` returns NULL.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import sys
import sysconfig
import threading
from typing import List, Sequence

import numpy as np

from ..utils.native_build import build_shared_lib

__all__ = ["load_capi", "CPredictor", "PT_Output", "DEVICE_ENV",
           "CSRC", "BUILD_DIR", "LIB_NAME", "python_link_flags"]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "paddle_tpu_torch_capi")
LIB_NAME = "libpaddle_tpu_torch_capi.so"
DEVICE_ENV = "PADDLE_TPU_TORCH_CAPI_DEVICE"
_SOURCES = ("predictor_capi.cpp", "paddle_tpu_capi.h")
_LOCK = threading.Lock()
_LIB = None


class PT_Output(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_float)),
                ("shape", ctypes.POINTER(ctypes.c_int64)),
                ("ndim", ctypes.c_int32),
                ("numel", ctypes.c_int64)]


def python_link_flags() -> List[str]:
    """``-L<libdir> -lpythonX.Y`` for this interpreter's shared runtime
    (empty when it has none: the symbols then come from the process that
    loads the shim)."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    if libdir and os.path.exists(os.path.join(libdir,
                                              f"libpython{ver}.so")):
        return [f"-L{libdir}", f"-lpython{ver}",
                f"-Wl,-rpath,{libdir}"]
    return []


def _build() -> str:
    """Compile the shim into ``BUILD_DIR`` unless the built library
    matches the sources; returns its path."""
    so = os.path.join(BUILD_DIR, LIB_NAME)
    prefix = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
              f"-I{sysconfig.get_path('include')}"]
    sources = [os.path.join(CSRC, "predictor_capi.cpp")]
    link = python_link_flags()
    # the sources, the command and the interpreter: a library built for
    # another Python is built again
    h = hashlib.sha256(" ".join(prefix + sources + link).encode())
    h.update(sys.version.encode())
    for name in _SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    stamp = so + ".sha256"
    if os.path.exists(so) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return so
    # compiled to a private file and renamed: concurrent builds agree
    build_shared_lib(prefix, sources, so, what="C ABI build",
                     link_flags=link)
    with open(f"{stamp}.{os.getpid()}", "w") as f:
        f.write(digest)
    os.replace(f"{stamp}.{os.getpid()}", stamp)
    return so


def load_capi() -> ctypes.CDLL:
    """Compile (when needed) and dlopen the C ABI; raises on failure
    (the C surface is a product feature, not a soft fallback)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_build(), mode=ctypes.RTLD_GLOBAL)
        lib.PT_NewPredictor.restype = ctypes.c_void_p
        lib.PT_NewPredictor.argtypes = [ctypes.c_char_p]
        lib.PT_PredictorRun.restype = ctypes.c_int32
        lib.PT_PredictorRun.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.PT_GetOutput.restype = ctypes.c_int32
        lib.PT_GetOutput.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                     ctypes.POINTER(PT_Output)]
        lib.PT_FreeOutput.argtypes = [ctypes.POINTER(PT_Output)]
        lib.PT_DeletePredictor.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class CPredictor:
    """ctypes harness over the C ABI (what predictor.go is in Go).
    Inputs go in as float32, outputs come back as float32 numpy
    arrays."""

    def __init__(self, model_path_prefix: str):
        self._lib = load_capi()
        self._h = self._lib.PT_NewPredictor(
            model_path_prefix.encode("utf-8"))
        if not self._h:
            raise RuntimeError(
                f"PT_NewPredictor failed for '{model_path_prefix}' (the "
                f"reason is on stderr)")

    def run(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        lib = self._lib
        arrs = [np.ascontiguousarray(a, np.float32) for a in inputs]
        n = len(arrs)
        bufs = (ctypes.POINTER(ctypes.c_float) * n)(
            *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
              for a in arrs])
        shapes_store = [(ctypes.c_int64 * max(a.ndim, 1))(*a.shape)
                        for a in arrs]
        shapes = (ctypes.POINTER(ctypes.c_int64) * n)(
            *[ctypes.cast(s, ctypes.POINTER(ctypes.c_int64))
              for s in shapes_store])
        ndims = (ctypes.c_int32 * n)(*[a.ndim for a in arrs])
        n_out = lib.PT_PredictorRun(self._h, bufs, shapes, ndims, n)
        if n_out < 0:
            raise RuntimeError("PT_PredictorRun failed")
        outs = []
        for i in range(n_out):
            o = PT_Output()
            if lib.PT_GetOutput(self._h, i, ctypes.byref(o)) != 0:
                lib.PT_FreeOutput(ctypes.byref(o))
                raise RuntimeError(f"PT_GetOutput({i}) failed")
            shape = tuple(o.shape[d] for d in range(o.ndim))
            arr = np.ctypeslib.as_array(o.data, shape=(max(o.numel, 1),))
            outs.append(arr[:o.numel].copy().reshape(shape))
            lib.PT_FreeOutput(ctypes.byref(o))
        return outs

    def close(self):
        if getattr(self, "_h", None):
            self._lib.PT_DeletePredictor(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
