"""Program analysis (the counterpart of ``paddle_tpu/static/analysis``):
the def-use graph, the verifier and hazard passes, the cost model and
the epilogue-fusion pass, over the recorded op list.

- :func:`check` runs the verifier and hazard passes and returns
  :class:`Diagnostic` records; :func:`verify` raises
  ``GraphVerificationError`` on an error (``Program.verify()``);
- :func:`analyze` (``Program.analyze()``): FLOPs and bytes per op with
  an explicit ``unmodeled`` bucket, donation-aware peak bytes, a
  roofline over :data:`CHIP_SPECS`, the hazards, and the fusion
  candidates with what the Executor realizes;
- ``FLAGS_static_verify`` makes ``static.Executor`` verify each program
  version before its first build; ``FLAGS_static_anchors`` only records
  ``file:line`` anchors.

Not ported: shardcheck (``static/analysis/shardcheck.py``), with
ROADMAP A5.
"""
from . import cost, fusion, graph, hazards, liveness, passes  # noqa: F401
from .cost import (CHIP_SPECS, ChipSpec, OpCost, ProgramReport,  # noqa: F401
                   analyze, compile_summary, resolve_perf_chip)
from .graph import DefUseGraph  # noqa: F401
from .hazards import (HAZARD_PASS_REGISTRY, DonationAliasPass,  # noqa: F401
                      HostTransferPass, WideDtypePass, hazard_passes)
from .liveness import MemoryEstimate, aval_bytes, estimate_memory  # noqa
from .passes import (PASS_REGISTRY, AnalysisPass, CrossProgramLeakPass,  # noqa
                     DeadCodePass, Diagnostic, NameCollisionPass,
                     ShapeDtypeConsistencyPass, UseBeforeProducePass,
                     check, default_passes, verify)

__all__ = [
    "DefUseGraph", "Diagnostic", "AnalysisPass", "UseBeforeProducePass",
    "CrossProgramLeakPass", "DeadCodePass", "ShapeDtypeConsistencyPass",
    "NameCollisionPass", "check", "verify", "default_passes",
    "PASS_REGISTRY",
    "analyze", "compile_summary", "ProgramReport", "OpCost", "ChipSpec",
    "CHIP_SPECS", "MemoryEstimate", "estimate_memory", "aval_bytes",
    "hazard_passes", "HostTransferPass", "WideDtypePass",
    "DonationAliasPass", "HAZARD_PASS_REGISTRY", "resolve_perf_chip",
]
