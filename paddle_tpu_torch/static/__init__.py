"""paddle.static: the static-graph facade (the part of
``paddle_tpu/static/__init__.py`` the single-device training path
needs).

A Program is an op list recorded through the same dispatch point eager
code uses; ``Executor.run(program, feed, fetch_list)`` interprets it,
with the forward, the gradients and the optimizer's update in one call.
A static training script runs as it does on paddle_tpu::

    paddle.enable_static()
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 128], "float32")
        ...
        optimizer.Adam(1e-3).minimize(loss)
    exe = static.Executor()
    exe.run(main, feed={"x": ...}, fetch_list=[loss])

Parameters go to ``get_device()`` (``set_device("cpu")`` for the CPU).
With ``FLAGS_use_pallas_kernels`` on (the default) the Executor fuses
matmul-epilogue chains into the fused epilogue kernels and updates a
plain f32 Adam with the fused Adam kernel.

``Program.verify`` runs the verifier and hazard passes and
``Program.analyze`` the cost model (:mod:`.analysis`);
``FLAGS_static_verify`` makes the Executor verify before it builds.

``save_inference_model`` prunes a Program to its fetch variables and
exports the Executor's replay of it (:mod:`.io`, in ``jit.save``'s
format); ``load_inference_model`` gives a program ``Executor.run``
serves.  ``BuildStrategy`` and ``CompiledProgram`` are as thin as in
paddle_tpu: a toggle the port's design satisfies is accepted, one it
has no counterpart for raises.

Not ported yet: shardcheck (A5).  Control flow is ``static.nn.cond``,
``case``, ``switch_case`` and ``while_loop``.
"""
from __future__ import annotations

from . import analysis, nn  # noqa: F401
from .executor import Executor, global_scope  # noqa: F401
from .io import load_inference_model, save_inference_model  # noqa: F401
from .program import (Program, Variable, data, default_main_program,  # noqa
                      default_startup_program, program_guard,
                      reset_default_programs)
from ..jit.static_function import InputSpec  # noqa: F401

__all__ = ["Program", "Variable", "data", "default_main_program",
           "default_startup_program", "program_guard", "Executor",
           "global_scope", "save_inference_model", "load_inference_model",
           "InputSpec", "nn", "BuildStrategy", "CompiledProgram",
           "reset_default_programs", "analysis"]


class BuildStrategy:
    """reference: fluid/compiler.py BuildStrategy (pass toggles consumed
    by ParallelExecutor's graph passes).

    The toggles in ``_ABSORBED`` name what the port does in their place
    whatever they are set to; they are accepted.  Knobs that would
    select an execution strategy the port does not have raise instead
    of being swallowed (every toggle real or loud)."""

    # reference pass -> what the port does instead
    _ABSORBED = {
        "fuse_elewise_add_act_ops": "the Executor's epilogue-fusion pass",
        "fuse_bn_act_ops": "eager PyTorch ops (cuDNN batch norm)",
        "fuse_bn_add_act_ops": "eager PyTorch ops (cuDNN batch norm)",
        "fuse_broadcast_ops": "eager PyTorch ops",
        "fuse_all_optimizer_ops": "the fused Adam kernel",
        "fuse_all_reduce_ops": "DataParallel's bucketed all-reduce",
        "fuse_relu_depthwise_conv": "eager PyTorch ops (cuDNN)",
        "enable_inplace": "in-place parameter and slot updates",
        "memory_optimize": "PyTorch's caching allocator",
        "enable_auto_fusion": "the Executor's epilogue-fusion pass",
        "cache_runtime_context": "the Executor's step cache",
        "sync_batch_norm": "nn.SyncBatchNorm",
        "enable_addto": "autograd's gradient accumulation",
    }
    _UNSUPPORTED = {
        "reduce_strategy": "Reduce-mode grad scattering (vs AllReduce)",
        "gradient_scale_strategy": "customized per-device loss scaling — "
                                   "scale inside the loss function",
        "build_cuda_graph": "the Executor captures no CUDA graph",
        "fused_attention": "use FLAGS_use_pallas_kernels (flash kernel)",
        "fused_feedforward": "use FLAGS_use_pallas_kernels (the fused "
                             "epilogue kernels)",
    }

    def __init__(self):
        for k in self._ABSORBED:
            object.__setattr__(self, k, False)

    def __setattr__(self, key, value):
        if key in self._ABSORBED:
            object.__setattr__(self, key, value)
            return
        if key in self._UNSUPPORTED:
            raise NotImplementedError(
                f"BuildStrategy.{key}: {self._UNSUPPORTED[key]} "
                f"(no silent toggles — fluid/compiler.py parity shim)")
        raise AttributeError(
            f"BuildStrategy has no toggle {key!r}; known toggles: "
            f"{sorted(self._ABSORBED)}")


class CompiledProgram:
    """Parity shim (reference: fluid/compiler.py CompiledProgram): the
    Executor already builds whole steps, so a program needs no wrapper.
    ``build_strategy`` is validated, not ignored (see BuildStrategy)."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        if build_strategy is not None and not isinstance(build_strategy,
                                                         BuildStrategy):
            raise TypeError(
                f"CompiledProgram(build_strategy=...) expects a "
                f"paddle.static.BuildStrategy (got "
                f"{type(build_strategy).__name__}); its toggles are "
                f"checked against what the port does — there is no "
                f"silent pass-through")
        self._build_strategy = build_strategy

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        """reference: compiler.py with_data_parallel — replicated
        ParallelExecutor graphs do not exist in this design; it raises
        rather than pretend (use parallel.DataParallel or
        parallel.SpmdTrainStep)."""
        raise NotImplementedError(
            "CompiledProgram.with_data_parallel: multi-device execution "
            "is parallel.DataParallel / parallel.SpmdTrainStep over "
            "torch.distributed; replicated ParallelExecutor graphs do "
            "not exist in this design")

    def __getattr__(self, item):
        return getattr(self._program, item)
