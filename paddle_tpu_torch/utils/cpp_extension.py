"""The C++ custom-op extension path (the counterpart of
``paddle_tpu/utils/cpp_extension.py``; reference:
``python/paddle/utils/cpp_extension`` and
``paddle/fluid/framework/custom_operator.cc``): compile a user's C++
kernels at run time and call them as ops.

paddle_tpu compiles against the XLA FFI and registers custom-call
targets.  Here the framework ABI is torch's operator registration: the
sources define their ops with ``TORCH_LIBRARY(<name>, m)`` (the schema,
``m.def("leaky_fwd(Tensor x, float alpha) -> Tensor")``) and register
their handlers with ``TORCH_LIBRARY_IMPL(<name>, CPU, m)``, both from
``torch/library.h`` (torch's operator headers, not the pybind
``torch/extension.h``).  :func:`load` compiles them with the host
``g++`` through :mod:`.native_build`, links them against torch's own
libraries, loads the library with ``torch.ops.load_library`` and returns
one callable an op: ``torch.ops.<name>.<symbol>``.

``functions`` keeps paddle_tpu's spec:

- ``symbol``: the registered op's name (default: the key), bare (in the
  ``name`` namespace) or qualified ``"ns::op"``;
- ``out``: the output's shape and dtype, registered as the op's
  ``Meta`` kernel, so the op records into a static ``Program`` (whose
  shapes come from meta tensors) and traces under ``torch.export``:
  ``"like:<i>"`` (tensor input i's), a ``(shape, dtype)`` pair or a
  tensor (or a list of them for several outputs), or a callable taking
  the meta tensor inputs and returning one of those;
- ``vmap_method``: ``"sequential"`` (the default) registers a vmap rule
  (``torch.library.register_vmap``) that calls the op once per element
  of the batch dimension and stacks the results, as
  ``jax.ffi.ffi_call``'s method does; None registers none.

Handlers are host kernels: they register for torch's CPU dispatch key
only, as paddle_tpu's FFI handlers register for the CPU platform.  On a
CUDA tensor an op raises torch's dispatch error, which names it; it is
never copied to the host.  A kernel for the card is a hand-written CUDA
kernel behind its own wrapper (``ops/cuda``), which
``utils.custom_op.register_custom_op`` takes like any function.

The library is cached in the build directory under a key of the
sources' contents, the flags, torch's version and include directory and
its C++ ABI: a library built against one torch is never loaded by
another, and nothing is rebuilt when nothing changed.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.dtype import convert_dtype

__all__ = ["load", "get_build_directory", "CppExtension"]

# per qualified op name: its ``out`` spec (read by the one Meta kernel a
# process registers for the op) and the torch.library registrations,
# kept alive for the life of the process
_out_specs: Dict[str, object] = {}
_libraries: Dict[str, torch.library.Library] = {}
_vmapped: set = set()


def get_build_directory() -> str:
    """``$PADDLE_TPU_EXTENSION_DIR``, else a per-user directory under
    the temporary directory (reference: ``get_build_directory``)."""
    d = os.environ.get("PADDLE_TPU_EXTENSION_DIR")
    if not d:
        d = os.path.join(tempfile.gettempdir(),
                         f"paddle_tpu_torch_extensions_{os.getuid()}")
    os.makedirs(d, exist_ok=True)
    return d


def _torch_dirs():
    root = os.path.dirname(os.path.abspath(torch.__file__))
    return os.path.join(root, "include"), os.path.join(root, "lib")


def _meta_of(spec, inputs):
    """The meta output(s) an ``out`` spec gives for the meta inputs."""
    if isinstance(spec, str):
        if not spec.startswith("like:"):
            raise ValueError("string out spec must be 'like:<input "
                             f"index>', got {spec!r}")
        return torch.empty_like(inputs[int(spec[5:])], device="meta")
    if callable(spec):
        spec = spec(*inputs)
    if hasattr(spec, "dtype"):          # a tensor or a shape-dtype struct
        return torch.empty(tuple(spec.shape), dtype=convert_dtype(
            spec.dtype), device="meta")
    if (isinstance(spec, (tuple, list)) and len(spec) == 2
            and not isinstance(spec[1], (tuple, list, torch.Tensor))
            and isinstance(spec[0], (tuple, list, torch.Size))):
        return torch.empty(tuple(spec[0]), dtype=convert_dtype(spec[1]),
                           device="meta")
    return tuple(_meta_of(s, inputs) for s in spec)


def _register_meta(qualname: str, out) -> None:
    """The op's Meta kernel, reading the latest ``out`` spec."""
    _out_specs[qualname] = out
    if qualname in _libraries:
        return
    ns, op = qualname.split("::")
    lib = torch.library.Library(ns, "IMPL")

    def meta(*args, **kwargs):
        return _meta_of(_out_specs[qualname], [
            a for a in args if isinstance(a, torch.Tensor)])

    lib.impl(op, meta, "Meta")
    _libraries[qualname] = lib


def _register_sequential_vmap(qualname: str, opov) -> None:
    """A vmap rule that runs the op once per element of the batch
    dimension and stacks the results along dim 0."""
    if qualname in _vmapped:
        return

    def rule(info, in_dims, *args, **kwargs):
        outs = [opov(*[a.select(d, i) if d is not None else a
                       for a, d in zip(args, in_dims)], **kwargs)
                for i in range(info.batch_size)]
        if isinstance(outs[0], (tuple, list)):
            stacked = tuple(torch.stack(o) for o in zip(*outs))
            return stacked, (0,) * len(stacked)
        return torch.stack(outs), 0

    torch.library.register_vmap(qualname, rule,
                                lib=_libraries.get(qualname))
    _vmapped.add(qualname)


def _make_op(opov, name: str) -> Callable:
    def op(*args, **attrs):
        args = [torch.from_numpy(np.ascontiguousarray(a))
                if isinstance(a, np.ndarray) else a for a in args]
        attrs = {k: v.item() if isinstance(v, np.generic) else v
                 for k, v in attrs.items()}
        return opov(*args, **attrs)

    op.__name__ = name
    return op


def load(name: str, sources: Sequence[str], functions: Dict[str, dict],
         extra_cxx_cflags: Optional[Sequence[str]] = None,
         build_directory: Optional[str] = None,
         verbose: bool = False) -> SimpleNamespace:
    """Compile ``sources`` into ``lib<name>_<key>.so`` (unless a build
    with the same key is there), load it and return a namespace with one
    callable per entry of ``functions`` (the module docstring has the
    spec) and ``__so_path__``.

    A compile error raises ``RuntimeError`` ("compiler failed") with
    the compiler's output, a missing source ``FileNotFoundError``, a
    symbol the library does not define ``AttributeError``, and an op
    with a handler for the card ``ValueError``."""
    build_dir = build_directory or get_build_directory()
    os.makedirs(build_dir, exist_ok=True)
    srcs = [os.path.abspath(s) for s in sources]
    for s in srcs:
        if not os.path.exists(s):
            raise FileNotFoundError(f"cpp_extension.load: source {s}")
    inc, lib_dir = _torch_dirs()
    abi = int(bool(torch._C._GLIBCXX_USE_CXX11_ABI))
    cflags: List[str] = (["-O2", "-fPIC", "-shared", "-std=c++20",
                          f"-D_GLIBCXX_USE_CXX11_ABI={abi}", f"-I{inc}"]
                         + list(extra_cxx_cflags or []))
    h = hashlib.sha1()
    for part in [torch.__version__, inc] + cflags:
        h.update(part.encode())
        h.update(b"\0")
    for s in srcs:
        h.update(s.encode())
        with open(s, "rb") as f:
            h.update(f.read())
    so_path = os.path.join(build_dir, f"lib{name}_{h.hexdigest()[:12]}.so")
    if not os.path.exists(so_path):
        from .native_build import build_shared_lib
        build_shared_lib(["g++"] + cflags, srcs, so_path, verbose=verbose,
                         what="cpp_extension.load",
                         link_flags=[f"-L{lib_dir}", "-lc10", "-ltorch_cpu",
                                     f"-Wl,-rpath,{lib_dir}"])
    torch.ops.load_library(so_path)
    ns = {}
    for op_name, spec in functions.items():
        symbol = spec.get("symbol", op_name)
        qualname = symbol if "::" in symbol else f"{name}::{symbol}"
        lib_ns, sym = qualname.split("::")
        opov = getattr(getattr(torch.ops, lib_ns), sym).default
        for key in ("CUDA", "CompositeExplicitAutograd",
                    "CompositeImplicitAutograd"):
            if torch._C._dispatch_has_kernel_for_dispatch_key(qualname,
                                                              key):
                raise ValueError(
                    f"cpp_extension.load: op {qualname} registers a {key} "
                    "handler; an extension's handlers register for the "
                    "CPU only")
        _register_meta(qualname, spec["out"])
        if spec.get("vmap_method", "sequential") == "sequential":
            _register_sequential_vmap(qualname, opov)
        ns[op_name] = _make_op(opov, op_name)
    module = SimpleNamespace(**ns)
    module.__so_path__ = so_path
    return module


class CppExtension:
    """reference: ``cpp_extension.CppExtension`` (the setuptools
    ahead-of-time path).  Building wheels of custom ops is not part of
    the port: constructing one raises, naming :func:`load`."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "CppExtension/setup(): ahead-of-time wheel builds are not "
            "supported — use paddle_tpu_torch.utils.cpp_extension.load("
            "name, sources, functions) to compile and register torch "
            "operators at run time")
