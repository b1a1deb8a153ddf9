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

- the eager core (``bench_lenet_dygraph``'s training half): the paddle
  :class:`Tensor` and :class:`Parameter` over ``torch.Tensor`` with
  torch's autograd as the tape (:func:`grad`, :func:`no_grad`,
  ``backward``), the op library of :mod:`.ops` (creation, math,
  reduction, manipulation, logic, linalg, random) at the top level and
  as Tensor methods, the eager :class:`nn.Layer` with the conv, pooling,
  activation, loss and container layers, :class:`optimizer.SGD` and
  :class:`optimizer.Momentum`, L1/L2 decay, parameter groups,
  :func:`save`/:func:`load` in paddle_tpu's file format, and
  ``vision.models.LeNet``;
- ResNet-50 training (bench's ``bench_resnet50``): the norm layers
  with paddle's running statistics (:class:`nn.BatchNorm2D` and its
  siblings, GroupNorm, InstanceNorm, LocalResponseNorm, SpectralNorm),
  their updates carried through ``jit.TrainStep`` (recompute,
  accumulation, a skipped loss-scaled step), ``vision.models`` (ResNet,
  VGG, MobileNet) and :mod:`.metric`;
- recurrent language-model training: the recurrent layers and cells
  (:class:`nn.LSTM`, ``GRU``, ``SimpleRNN``, ``RNN``, ``BiRNN``), the
  sparse embedding gradient (``nn.Embedding(sparse=True)``, read by the
  optimizers as a ``core.selected_rows.SelectedRows``) with SGD's and
  ``Adam(lazy_mode=True)``'s row-wise updates, the clips by value and
  by norm, the sequence ops of :mod:`.ops.sequence`, and :func:`cond`,
  :func:`case`, :func:`switch_case` and :func:`while_loop`, eager and
  in a static Program.

- export and inference: :func:`jit.to_static` (dy2static's
  control-flow conversion, run eagerly), :func:`jit.save` /
  :func:`jit.load` and ``static.save_inference_model`` /
  ``load_inference_model`` (``torch.export`` of the eval forward, the
  hand kernels' forwards kept as custom ops), and :mod:`.inference`
  (``Config``, ``create_predictor``, a ``Predictor`` that pads to a
  bucket);

- the rest of the eager surface: the tail optimizers (Adamax,
  Adagrad, Adadelta, RMSProp, :class:`optimizer.Lamb`,
  :class:`optimizer.LarsMomentum`, Ftrl, Dpsgd, ProximalGD,
  ProximalAdagrad, DecayedAdagrad) and :mod:`.optimizer.extras` (EMA,
  ModelAverage, Lookahead), second derivatives
  (``grad(create_graph=True)``; through a hand kernel's autograd
  Function exact on the CPU and refused on the card), the flags
  registry (:func:`get_flags`, :func:`set_flags`), the names of
  ``framework_compat`` (``*Place``, the dygraph switches, the CUDA RNG
  state, :func:`create_parameter`, :func:`flops`), the device queries,
  :func:`paged_attention` with :func:`register_paged_attention_kernel`,
  and :mod:`.ops.pallas`, the JAX package's kernel entries over the
  CUDA kernels;

- the rest of serving and the observability package: the dynamic-
  batching ``InferenceEngine``, ``/predict`` and the model registry
  with its ``ElasticityController``, the C ABI, weight hot swap
  (:mod:`.serving.hotswap` over :class:`~.utils.checkpoint.
  SnapshotStore`), and :mod:`.observability` (tracer, compile
  attribution, Prometheus, the flight recorder, the performance
  observatory, SLO monitors, the fleet spool and views).

- the data pipeline and the high-level API: :mod:`.io` (datasets,
  samplers, the ``DataLoader`` with worker processes over shared memory
  and the fleet's ``InMemoryDataset``/``QueueDataset``), :mod:`.hapi`
  (:class:`Model`, the callbacks, :func:`summary`), ``vision.datasets``
  and ``vision.transforms``, :mod:`.text` (the text datasets and the
  native WordPiece tokenizer), :mod:`.distribution`, and ``utils.fs``,
  ``utils.crypto`` and ``utils.native_build`` (``save``/``load`` through
  registered filesystems, encrypted).

Models, pools, engines, static parameters and new tensors go to the
current CUDA device unless the caller passes ``device=`` / ``place=``
(e.g. ``"cpu"``) or calls ``set_device``; with no GPU and neither, they
raise.
"""
from __future__ import annotations

import builtins as _builtins

__version__ = "0.1.0"

from . import (amp, core, distributed, distribution,  # noqa: F401
               framework_io, hapi, inference, io, jit, metric, nn,
               observability, ops, optimizer, parallel, serving, static,
               testing, text, utils, vision)
from .core.autograd import (enable_grad, grad, is_grad_enabled,  # noqa
                            no_grad)
from .core.dispatch import apply  # noqa: F401
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.dtype import (bfloat16, bool_, complex64, complex128,  # noqa
                         convert_dtype, float16, float32, float64,
                         get_default_dtype, int8, int16, int32, int64,
                         set_default_dtype, uint8)
from .core.placement import device  # noqa: F401
from .core.rng import get_rng_state, next_key, seed, set_rng_state  # noqa
from .framework_compat import (CPUPlace, CUDAPinnedPlace,  # noqa: F401
                               CUDAPlace, TPUPlace, XPUPlace,
                               create_parameter, disable_dygraph,
                               enable_dygraph, flops, get_cuda_rng_state,
                               get_cudnn_version, in_dygraph_mode,
                               set_cuda_rng_state, set_printoptions)
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from .device import (device_count, get_all_devices,  # noqa: F401
                     get_device, is_compiled_with_cuda,
                     is_compiled_with_tpu, is_compiled_with_xpu,
                     set_device)
from .framework_io import load, save  # noqa: F401
from .hapi import Model, summary  # noqa: F401
from .nn.layer_base import ParamAttr  # noqa: F401
from .ops import linalg, monkey_patch_tensor  # noqa: F401
from .nn.functional import as_array  # noqa: F401
from .ops.attention import (paged_attention,  # noqa: F401
                            paged_attention_supported,
                            register_paged_attention_kernel)
from .ops.control_flow import case, cond, switch_case, while_loop  # noqa
from .parallel import DataParallel  # noqa: F401
from .ops.creation import *  # noqa: F401,F403
from .ops.linalg import cholesky, dist, histogram, inverse, norm  # noqa
from .ops.logic import *  # noqa: F401,F403
from .ops.manipulation import *  # noqa: F401,F403
from .ops.math import *  # noqa: F401,F403
from .ops.random import *  # noqa: F401,F403
from .ops.reduction import *  # noqa: F401,F403
from .optimizer import regularizer  # noqa: F401

__all__ = (["amp", "core", "distributed", "distribution",
            "framework_io", "hapi", "inference", "io", "jit", "metric",
            "nn", "observability", "text", "Model", "summary",
            "ops", "optimizer", "parallel", "serving", "static", "testing",
            "utils", "vision", "device", "seed", "get_rng_state",
            "set_rng_state", "set_device", "get_device", "ParamAttr",
            "Tensor", "Parameter", "to_tensor", "grad", "no_grad",
            "enable_grad", "is_grad_enabled", "save", "load", "linalg",
            "regularizer", "monkey_patch_tensor", "cholesky", "dist",
            "histogram", "inverse", "norm", "convert_dtype",
            "get_default_dtype", "set_default_dtype", "bfloat16", "bool_",
            "complex64", "complex128", "float16", "float32", "float64",
            "int8", "int16", "int32", "int64", "uint8",
            "enable_static", "disable_static", "in_dynamic_mode", "cond",
            "case", "switch_case", "while_loop", "apply", "as_array",
            "next_key", "get_flags", "set_flags", "CPUPlace",
            "CUDAPinnedPlace", "CUDAPlace", "TPUPlace", "XPUPlace",
            "create_parameter", "disable_dygraph", "enable_dygraph",
            "flops", "get_cuda_rng_state", "get_cudnn_version",
            "in_dygraph_mode", "set_cuda_rng_state", "set_printoptions",
            "device_count", "get_all_devices", "is_compiled_with_cuda",
            "is_compiled_with_tpu", "is_compiled_with_xpu",
            "paged_attention", "paged_attention_supported",
            "register_paged_attention_kernel", "DataParallel",
            "builtins_slice", "annotations"]
           + ops.creation.__all__ + ops.logic.__all__
           + ops.manipulation.__all__ + ops.math.__all__
           + ops.random.__all__ + ops.reduction.__all__)

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


# fleet telemetry: with FLAGS_obs_spool_dir in the environment the
# exporter installs at import, so a child process spawned with the flag
# spools with no code change.  Unset, this is one flag read.
from .core import flags as _flags  # noqa: E402

if _flags.get_flag("obs_spool_dir"):
    from .observability import export as _obs_export  # noqa: E402

    _obs_export.install_exporter()

# the JAX package's top level carries the builtin ``slice`` under this
# name (its ``slice`` is the op)
builtins_slice = _builtins.slice
