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

Not ported yet: ``save_inference_model`` / ``load_inference_model``
(``static/io``), ``InputSpec``, ``BuildStrategy`` / ``CompiledProgram``
(ROADMAP A4) and shardcheck (A5).  Control flow is ``static.nn.cond``,
``case``, ``switch_case`` and ``while_loop``.
"""
from __future__ import annotations

from . import analysis, nn  # noqa: F401
from .executor import Executor, global_scope  # noqa: F401
from .program import (Program, Variable, data, default_main_program,  # noqa
                      default_startup_program, program_guard,
                      reset_default_programs)

__all__ = ["Program", "Variable", "data", "default_main_program",
           "default_startup_program", "program_guard", "Executor",
           "global_scope", "nn", "reset_default_programs", "analysis"]
