"""paddle.inference: the deployment API (the counterpart of
``paddle_tpu/inference/__init__.py``; reference:
paddle/fluid/inference/api/analysis_predictor.h:82 and paddle_infer::
Config).

The artifact is what ``jit.save`` or ``static.save_inference_model``
wrote (``paddle_tpu_torch.export.v1``: a ``torch.export`` program and
its weights).  :class:`Predictor` loads it once onto its device and
serves :meth:`Predictor.run`: the inputs go to the device, the program
runs there (the hand kernels' custom ops launch the CUDA kernels on the
card), and the outputs stay on the device until they are read
(``np.asarray(out)`` or an output handle's ``copy_to_cpu``).

**Device.**  ``Config.enable_use_gpu()`` serves on the current CUDA
device, ``Config.disable_gpu()`` on the CPU; with neither, the device
``set_device`` chose, else the current CUDA device, and with no GPU and
no request for the CPU it raises (as the rest of the port does).

**Shapes.**  A program saved with dynamic dims takes any size there.
What the JAX package compiles per shape bucket, the port prepares: a
bucket declared with ``Config.add_shape_bucket`` (and a fully static
program's own shapes) is run once on zeros at load, and
:meth:`Predictor.num_compiled_variants` counts the distinct input
signatures prepared or served.  Under the ``"bucket"`` pad policy
(``FLAGS_inference_pad_policy``, the default) a batch size not seen
before is padded with zero rows to the smallest known bucket that fits,
else the next power of two, and the outputs that carry the batch dim
(:meth:`Predictor.batched_output_mask`, from the saved program) are
sliced back, so a steady stream of ragged batches adds no variant.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.flags import get_flag
from ..core.tensor import wrap
from ..jit.save_load import SUFFIX_MODEL, SUFFIX_PARAMS, load_artifact
from ..utils import monitor

_SERIALS = itertools.count(1)

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "SUFFIX_MODEL", "SUFFIX_PARAMS"]

_PAD_POLICIES = ("bucket", "none")


class Config:
    """reference: inference/api/paddle_analysis_config.h.

    ``Config(prog_file)`` or ``Config(prog_file, params_file)``: the path
    prefix used at save time (a ``.pdmodel`` suffix is taken off), and
    optionally another ``.pdiparams`` file with the same names."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file is not None and prog_file.endswith(SUFFIX_MODEL):
            prog_file = prog_file[: -len(SUFFIX_MODEL)]
        self.prog_file = prog_file
        self.params_file = params_file
        self._shape_buckets: List[Tuple[Tuple[int, ...], ...]] = []
        self._aot_on_load = True
        self._pad_policy: Optional[str] = None  # None -> FLAGS default
        self._use_gpu: Optional[bool] = None
        self._flags: Dict[str, object] = {}

    def set_prog_file(self, path: str):
        self.prog_file = path

    def model_dir(self):
        return self.prog_file

    def add_shape_bucket(self, *input_shapes: Sequence[int]):
        """Declare an input-shape combination to prepare at load."""
        self._shape_buckets.append(tuple(tuple(s) for s in input_shapes))

    def disable_aot_compile(self):
        """Prepare nothing at load."""
        self._aot_on_load = False

    def set_batch_pad_policy(self, policy: str):
        """``"bucket"`` pads an unseen batch size to a known bucket and
        slices the outputs back (assumes rows independent of each
        other, as inference nets are); ``"none"`` serves each batch size
        as it is."""
        if policy not in _PAD_POLICIES:
            raise ValueError(f"batch pad policy must be one of "
                             f"{_PAD_POLICIES}, got {policy!r}")
        self._pad_policy = policy

    def batch_pad_policy(self) -> str:
        return self._pad_policy or get_flag("inference_pad_policy")

    def enable_use_gpu(self, *a, **k):
        """Serve on the current CUDA device."""
        self._use_gpu = True

    def disable_gpu(self):
        """Serve on the CPU."""
        self._use_gpu = False

    def use_gpu(self) -> Optional[bool]:
        return self._use_gpu

    # -- accepted-for-parity switches (PyTorch runs the ops as saved) -----
    def enable_memory_optim(self, *a, **k):
        self._flags["memory_optim"] = True

    def switch_ir_optim(self, x=True):
        self._flags["ir_optim"] = x

    def enable_mkldnn(self, *a, **k):
        pass

    def set_cpu_math_library_num_threads(self, n):
        self._flags["cpu_threads"] = n

    def summary(self) -> str:
        return (f"Config(prog_file={self.prog_file}, "
                f"buckets={len(self._shape_buckets)}, "
                f"pad_policy={self.batch_pad_policy()}, "
                f"use_gpu={self._use_gpu}, flags={self._flags})")


class Tensor:
    """IO handle (reference: ZeroCopyTensor, analysis_predictor.h:143-151).
    ``copy_from_cpu`` stages the next input, ``share_external_data``
    stages a tensor without a copy (a CUDA tensor on the predictor's
    device is used as it is), ``copy_to_cpu`` reads an output."""

    def __init__(self, name: str, predictor: "Predictor", is_input: bool):
        self.name = name
        self._p = predictor
        self._is_input = is_input

    def _input_only(self):
        if not self._is_input:
            raise ValueError(f"{self.name} is an output handle")

    def copy_from_cpu(self, arr):
        self._input_only()
        self._p._inputs[self.name] = np.array(arr, copy=True)

    def share_external_data(self, arr):
        self._input_only()
        self._p._inputs[self.name] = arr

    def reshape(self, shape):
        pass  # the shape follows the staged array

    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            raise ValueError(f"{self.name} is an input handle")
        return np.asarray(self._p._outputs[self.name])

    def shape(self):
        src = self._p._inputs if self._is_input else self._p._outputs
        a = src.get(self.name)
        return list(a.shape) if a is not None else None


class Predictor:
    """reference: inference/api/analysis_predictor.h:82."""

    def __init__(self, config: Config):
        self.config = config
        dev = {True: "cuda", False: "cpu"}.get(config.use_gpu())
        self._program = load_artifact(config.prog_file, dev,
                                      config.params_file)
        self.device = self._program.device
        m = self._program.meta
        self._meta = m
        self._in_dtypes = [convert_dtype(d) for d in m["in_dtypes"]]
        self._input_names = list(m.get("feed_names") or [
            f"x{i}" for i in range(len(m["in_shapes"]))])
        self._output_names: Optional[List[str]] = (
            list(m["fetch_names"]) if m.get("fetch_names") else None)
        self._inputs: Dict[str, object] = {}
        self._outputs: Dict[str, torch.Tensor] = {}
        self._prepared: set = set()
        self._serial = next(_SERIALS)   # compile-attribution identity
        # batch sizes per rest-signature (shapes minus the leading dim)
        self._batch_buckets: Dict[tuple, set] = {}
        if config._aot_on_load:
            self._prepare_on_load()

    # -- variants ------------------------------------------------------------
    @staticmethod
    def _split_batch(sig):
        """``(rest, batch)`` when every input shares a leading dim, else
        ``(None, None)``: scalars or ragged leading dims are not
        padded."""
        batches = {s[0] for s, _ in sig if len(s) >= 1}
        if len(batches) != 1 or any(len(s) < 1 for s, _ in sig):
            return None, None
        return tuple((s[1:], d) for s, d in sig), batches.pop()

    def _register(self, sig, note="serve-path miss"):
        if sig in self._prepared:
            return
        self._prepared.add(sig)
        rest, batch = self._split_batch(sig)
        if rest is not None:
            self._batch_buckets.setdefault(rest, set()).add(batch)
        # recompile attribution: after load, each new signature is a new
        # bucket (paddle_tpu's cause names)
        from ..observability import record_compile
        record_compile("predictor", self._serial, {
            "bucket": tuple((s, d.replace("torch.", "")) for s, d in sig),
        }, note=note)

    def _prepare_on_load(self):
        shapes = list(self.config._shape_buckets)
        if all(d is not None for s in self._meta["in_shapes"] for d in s):
            shapes.append(tuple(tuple(s) for s in self._meta["in_shapes"]))
        for bucket in shapes:
            sig = tuple((tuple(int(d) for d in s), str(dt))
                        for s, dt in zip(bucket, self._in_dtypes))
            if sig not in self._prepared:
                self._program.run_flat([
                    torch.zeros(s, dtype=dt, device=self.device)
                    for (s, _), dt in zip(sig, self._in_dtypes)])
                self._register(sig, note="aot")

    def batched_output_mask(self) -> Optional[List[bool]]:
        """Which outputs carry the dynamic batch dim, from the saved
        program (None when it has no dynamic dim: padded outputs are
        then told by their leading size)."""
        return self._meta.get("out_batched")

    def _pick_bucket(self, rest, batch) -> int:
        fitting = [b for b in self._batch_buckets.get(rest, ()) if b >= batch]
        if fitting:
            return min(fitting)
        return 1 << (batch - 1).bit_length()

    def num_compiled_variants(self) -> int:
        """Distinct input signatures prepared or served so far."""
        return len(self._prepared)

    # -- handle API --------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_output_names(self) -> List[str]:
        if self._output_names is not None:
            return list(self._output_names)
        return [f"out{i}" for i in range(len(self._outputs) or 1)]

    def get_input_handle(self, name: str) -> Tensor:
        return Tensor(name, self, is_input=True)

    def get_output_handle(self, name: str) -> Tensor:
        return Tensor(name, self, is_input=False)

    # -- execution ---------------------------------------------------------
    def _on_device(self, a, dtype) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            t = torch.Tensor.as_subclass(torch.Tensor.detach(a),
                                         torch.Tensor)
        else:
            t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
        return t.to(self.device, dtype)

    def run(self, inputs: Optional[Sequence] = None) -> List[torch.Tensor]:
        """Serve one batch: ``run([arr, ...])``, or stage the inputs
        through the input handles first.  Returns the outputs (paddle
        Tensors on the predictor's device; ``np.asarray`` reads them),
        also readable through the output handles."""
        if inputs is not None:
            for n, a in zip(self._input_names, inputs):
                self._inputs[n] = a
        args = []
        for n, dt in zip(self._input_names, self._in_dtypes):
            if n not in self._inputs:
                raise ValueError(f"input '{n}' not staged; call "
                                 f"get_input_handle('{n}').copy_from_cpu()")
            args.append(self._on_device(self._inputs[n], dt))
        sig = tuple((tuple(a.shape), str(a.dtype)) for a in args)
        n_real = n_padded = None
        if sig not in self._prepared \
                and self.config.batch_pad_policy() == "bucket":
            rest, batch = self._split_batch(sig)
            if rest is not None:
                target = self._pick_bucket(rest, batch)
                if target != batch:
                    args = [torch.cat([a, a.new_zeros(
                        (target - batch,) + tuple(a.shape[1:]))])
                        for a in args]
                    sig = tuple((tuple(a.shape), str(a.dtype))
                                for a in args)
                    n_real, n_padded = batch, target
                    if sig in self._prepared:
                        monitor.stat_add("inference.pad_hits")
        if sig not in self._prepared:
            # a signature served the first time (paddle_tpu: a compile)
            monitor.stat_add("inference.compile_misses")
        outs = self._program.run_flat(args)
        self._register(sig)
        if n_real is not None:
            mask = self.batched_output_mask()
            outs = [o[:n_real]
                    if (o.dim() >= 1 and (mask[i] if mask is not None
                                          and i < len(mask)
                                          else o.shape[0] == n_padded))
                    else o for i, o in enumerate(outs)]
        outs = [wrap(o) for o in outs]
        names = self._output_names or [f"out{i}" for i in range(len(outs))]
        self._outputs = dict(zip(names, outs))
        self._output_names = names
        return outs


def create_predictor(config: Config) -> Predictor:
    """reference: paddle_infer::CreatePredictor."""
    return Predictor(config)
