"""Shared plumbing for the CUDA kernel tier.

- **build**: every ``csrc/*.cu`` file is compiled by its own ``nvcc``
  for ``sm_90a`` (all started together), and the objects are linked
  into one shared library with a plain C interface, at first use, into
  ``build/paddle_tpu_torch_kernels/`` at the repository root (listed in
  ``.gitignore``).  The library's name carries a hash of the
  sources, the headers they share (``csrc/*.cuh``) and the flags, so an
  edited source rebuilds and an unchanged one is loaded as it is.
  Python binds it with ``ctypes``: no PyTorch header is compiled, which
  keeps the build to seconds.  Nothing links against libcuda (no
  ``-lcuda``): the one libcuda function a kernel needs,
  ``cuTensorMapEncodeTiled`` (K6's TMA descriptors), is fetched at run
  time through ``cudaGetDriverEntryPoint``.  Thread-block clusters (K2f's
  layer_norm chains) are launched with ``cudaLaunchKernelEx``, from the
  runtime too.  Nothing here builds or imports a compiler when the
  module is imported.
- **gates**: :func:`dtype_ok` — f32 and bf16, the two types every
  kernel accumulates from in f32.
- **entry points**: ``ptt_paged_decode`` and
  ``ptt_paged_decode_max_clusters`` (``paged_attention.cu``),
  ``ptt_flash_fwd`` / ``ptt_flash_bwd_dq`` / ``ptt_flash_bwd_dkv``
  (``flash_attention.cu``), ``ptt_epilogue_fwd`` / ``ptt_epilogue_bwd``
  / ``ptt_epilogue_grads`` (``fused_epilogue.cu``),
  ``ptt_fused_adam`` / ``ptt_adam_chunk`` (``fused_adam.cu``) and
  ``ptt_chunk_matmul`` (``chunk_matmul.cu``), declared for ``ctypes`` in
  :func:`_declare`.
- **launch counts**: every wrapper adds one to
  ``launch_counts[<kernel>]`` where it launches its kernel, and nowhere
  else, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

__all__ = ["dtype_ok", "load_library", "count_launch", "launch_counts",
           "reset_launch_counts", "build_info"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
BUILD_DIR = os.path.join(_REPO, "build", "paddle_tpu_torch_kernels")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
              "-Xcompiler", "-fPIC"]

launch_counts: Dict[str, int] = {}
# what the last load did: library path, seconds spent building (0.0 when
# an existing library was loaded) and nvcc's report (registers, spills)
build_info: Dict[str, object] = {}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def dtype_ok(dtype) -> bool:
    return dtype in (torch.float32, torch.bfloat16)


def count_launch(name: str) -> None:
    launch_counts[name] = launch_counts.get(name, 0) + 1


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if not CUDA_HOME:
        raise RuntimeError("cannot build the CUDA kernels: no CUDA toolkit "
                           "found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.ptt_paged_decode
    fn.argtypes = [vp, vp, vp, vp, vp, vp,       # q k v table lengths out
                   i32, i32, i32, i32, i32, i32, i32,  # S H Hkv D P page N
                   ctypes.c_float, i32, i32, vp]  # scale C dtype stream
    fn.restype = i32
    fn = lib.ptt_paged_decode_max_clusters
    fn.argtypes = [i32, i32, i32, i32]           # D G dtype C
    fn.restype = i32
    # flash attention: pointers, then B H Lq Lk D, the (b, h, l) strides
    # of the query and key families, scale causal q_off k_off seed
    # drop_t dtype stream
    i64 = ctypes.c_longlong
    tail = [i32] * 5 + [i64] * 6 + [ctypes.c_float, i32, i32, i32,
                                    ctypes.c_uint, i32, i32, vp]
    for name, n_ptr in (("ptt_flash_fwd", 5), ("ptt_flash_bwd_dq", 7),
                        ("ptt_flash_bwd_dkv", 8)):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * n_ptr + tail
        fn.restype = i32
    # fused epilogue: tensors, M K N, then the recipe (codes, eps,
    # n_stages, operand pointers[, grad pointers], op_info, n_ops), dtype
    # and stream
    recipe = [vp, vp, i32, vp]
    fn = lib.ptt_epilogue_fwd
    fn.argtypes = [vp] * 3 + [i32] * 3 + recipe + [vp, i32, i32, vp]
    fn.restype = i32
    fn = lib.ptt_epilogue_bwd
    fn.argtypes = [vp] * 5 + [i32] * 3 + recipe + [vp, vp, i32, i32, vp]
    fn.restype = i32
    # grads: tensors, M K N, op_info, n_ops, the partials' rows, dw's
    # slices and rows a slice, dtype, stream
    fn = lib.ptt_epilogue_grads
    fn.argtypes = [vp] * 7 + [i32] * 3 + [vp] + [i32] * 5 + [vp]
    fn.restype = i32
    # fused Adam: table, block maps, n_blocks, lr, step, seven floats,
    # stream
    fn = lib.ptt_fused_adam
    fn.argtypes = [vp, vp, vp, i32, vp, vp, vp] + [ctypes.c_float] * 7 \
        + [vp]
    fn.restype = i32
    lib.ptt_adam_chunk.argtypes = []
    lib.ptt_adam_chunk.restype = i64
    # chunk matmul: x w out, M K N, ldx ldw ldo, dtype, stream
    fn = lib.ptt_chunk_matmul
    fn.argtypes = [vp] * 3 + [i32] * 3 + [i64] * 3 + [i32, vp]
    fn.restype = i32


def _build(so: str, sources) -> str:
    """One ``nvcc -c`` per source, all running at once, then one link;
    returns the compilers' report."""
    nvcc, tag = _nvcc(), f"{so}.{os.getpid()}"
    objs = [f"{tag}.{i}.o" for i in range(len(sources))]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    try:
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [(src, p.returncode) for src, p in zip(sources, procs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run([nvcc, ARCH, "-shared", "-o", f"{tag}.tmp",
                               *objs], capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{log}")
        os.replace(f"{tag}.tmp", so)   # atomic: concurrent builds agree
        return log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
        headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources + headers:
            with open(src, "rb") as f:
                h.update(f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR,
                          f"libpaddle_tpu_torch_{h.hexdigest()[:16]}.so")
        seconds, log = 0.0, ""
        if not os.path.exists(so):
            t0 = time.perf_counter()
            log = _build(so, sources)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        _declare(lib)
        build_info.update(path=so, build_seconds=seconds, nvcc_log=log)
        _lib = lib
        return lib
