"""jit: the whole-step trainer (``TrainStep``, run eagerly), ``to_static``
with dy2static's control-flow conversion, and ``save``/``load`` of a
deployable artifact captured by ``torch.export``."""
from .bind import bind, buffer_arrays, param_arrays, param_list  # noqa
from .lint import LintDiagnostic, lint  # noqa: F401
from .save_load import TranslatedLayer, load, save  # noqa: F401
from .static_function import (InputSpec, StaticFunction,  # noqa: F401
                              enable_to_static, not_to_static, to_static)
from .train_step import TrainStep  # noqa: F401

__all__ = ["TrainStep", "InputSpec", "StaticFunction", "to_static",
           "enable_to_static", "not_to_static", "save", "load",
           "TranslatedLayer", "lint", "LintDiagnostic", "bind",
           "param_arrays", "buffer_arrays", "param_list"]
