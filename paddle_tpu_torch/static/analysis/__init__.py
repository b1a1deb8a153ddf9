"""Static analysis over a recorded Program: the def-use graph, the
fusion candidates of the cost model and the epilogue-fusion pass (the
subset of ``paddle_tpu/static/analysis`` the Executor runs)."""
from . import cost, fusion, graph  # noqa: F401
from .graph import DefUseGraph  # noqa: F401

__all__ = ["DefUseGraph", "cost", "fusion", "graph"]
