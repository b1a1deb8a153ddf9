"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA
Hopper.

These slices are in:

- generative serving: the paged KV cache, the continuous-batching
  :class:`~.serving.GenerationEngine`, the reference
  :class:`~.serving.PagedDecoderLM`, the HTTP front end, and the
  hand-written CUDA paged-decode kernel;
- BERT masked-LM training: :mod:`.nn` (Linear, Embedding, LayerNorm,
  Dropout, MultiHeadAttention, TransformerEncoder and the functions
  they call), :mod:`.optimizer` (Adam, AdamW, global-norm clip, f32
  master weights), :func:`.amp.decorate` (O2), :class:`.jit.TrainStep`,
  and the hand-written CUDA flash-attention kernels, forward and
  backward;
- static-graph training: :func:`enable_static`, :mod:`.static`
  (Program, ``data``, ``program_guard``, Executor with the
  epilogue-fusion pass), ``Optimizer.minimize``, and the hand-written
  CUDA fused matmul-epilogue (forward and backward) and fused Adam
  kernels;
- hybrid-parallel training over ``torch.distributed``: :mod:`.distributed`
  (process group, mesh, collectives, launcher, strategy) and
  :mod:`.parallel` (tensor-parallel layers on the fused collective
  matmuls, ring attention, DataParallel, SpmdTrainStep), with the
  hand-written CUDA chunk matmul and the flash kernels' block entry;
- single-device GPT pretraining (``testing.models.build_gpt``, bench's
  ``bench_gpt``) with per-block :func:`.parallel.recompute`, and the
  whole-step training surface it stands on: ``jit.TrainStep``'s
  ``recompute``, ``accumulate_steps``, ``scaler`` and ``amp_level``,
  :mod:`.amp` (``auto_cast`` O1/O2, ``GradScaler``, ``decorate`` O1),
  :mod:`.optimizer.lr` (the ``LRScheduler`` family), :mod:`.nn.
  initializer`, :class:`ParamAttr`, :func:`zeros` and its siblings and
  :func:`transpose`; its attention runs the flash kernels' causal entry
  at head dim 96, forward twice a layer under recompute.

Models, pools, engines and static parameters go to the current CUDA
device unless the caller passes ``device=`` (e.g. ``"cpu"``) or calls
``set_device``; with no GPU and neither, they raise.
"""
from . import (amp, core, distributed, framework_io, jit, nn,  # noqa: F401
               ops, optimizer, parallel, serving, static, testing, utils)
from .core.placement import device  # noqa: F401
from .core.rng import seed  # noqa: F401
from .device import get_device, set_device  # noqa: F401
from .nn.layer_base import ParamAttr  # noqa: F401
from .ops.creation import (arange, empty, empty_like, full,  # noqa: F401
                           full_like, ones, ones_like, zeros, zeros_like)
from .ops.manipulation import transpose  # noqa: F401

__all__ = ["amp", "core", "distributed", "framework_io", "jit", "nn", "ops",
           "optimizer", "parallel", "serving", "static", "testing", "utils",
           "device", "seed", "set_device", "get_device", "ParamAttr",
           "arange", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "transpose",
           "enable_static", "disable_static", "in_dynamic_mode"]

_static_mode = False


def enable_static():
    """Static mode, as paddle_tpu has it: layer code run on
    ``static.data`` Variables records into the current Program (the
    recording itself keys on the Variables, in either mode)."""
    global _static_mode
    _static_mode = True


def disable_static(place=None):
    global _static_mode
    _static_mode = False


def in_dynamic_mode() -> bool:
    return not _static_mode
