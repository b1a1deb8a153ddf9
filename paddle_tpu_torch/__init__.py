"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA
Hopper.

Two slices are in:

- generative serving: the paged KV cache, the continuous-batching
  :class:`~.serving.GenerationEngine`, the reference
  :class:`~.serving.PagedDecoderLM`, the HTTP front end, and the
  hand-written CUDA paged-decode kernel;
- BERT masked-LM training: :mod:`.nn` (Linear, Embedding, LayerNorm,
  Dropout, MultiHeadAttention, TransformerEncoder and the functions
  they call), :mod:`.optimizer` (Adam, AdamW, global-norm clip, f32
  master weights), :func:`.amp.decorate` (O2), :class:`.jit.TrainStep`,
  and the hand-written CUDA flash-attention kernels, forward and
  backward.

Models, pools and engines go to the current CUDA device unless the
caller passes ``device=`` (e.g. ``"cpu"``); with no GPU and no
``device=`` they raise.
"""
from . import (amp, core, framework_io, jit, nn, ops,  # noqa: F401
               optimizer, serving, testing, utils)
from .core.placement import device  # noqa: F401
from .core.rng import seed  # noqa: F401

__all__ = ["amp", "core", "framework_io", "jit", "nn", "ops", "optimizer",
           "serving", "testing", "utils", "device", "seed"]
