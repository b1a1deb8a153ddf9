"""Typed error system (the counterpart of ``paddle_tpu.core.enforce``).

The error-code taxonomy as exception classes, so user code can catch
narrow categories; the port's ops raise them where the JAX package
does, and :func:`with_op_hint` attaches the failing op's name the same
way.  With a flight recorder installed (``observability``),
constructing any error of the taxonomy dumps the black box.
"""
from __future__ import annotations

from . import obs_hook

__all__ = ["EnforceError", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
           "PreconditionNotMetError", "PermissionDeniedError",
           "ExecutionTimeoutError", "UnimplementedError", "UnavailableError",
           "FatalError", "ExternalError", "GraphVerificationError",
           "enforce", "enforce_eq", "enforce_not_none", "with_op_hint"]


class EnforceError(RuntimeError):
    """Base of the taxonomy (reference: error_codes.proto).

    When a flight recorder is installed, constructing any error of the
    taxonomy dumps the black box; the handler dedups by exception
    object, so a later re-report (the Executor catching this error)
    never dumps twice."""
    code = "LEGACY"

    def __init__(self, *args):
        super().__init__(*args)
        h = obs_hook._crash
        if h is not None:
            h(self, f"enforce.{type(self).__name__}")


class InvalidArgumentError(EnforceError, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceError, KeyError):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceError, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceError):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceError, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceError):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceError):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceError, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceError, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceError):
    code = "UNAVAILABLE"


class FatalError(EnforceError):
    code = "FATAL"


class ExternalError(EnforceError):
    code = "EXTERNAL"


class GraphVerificationError(PreconditionNotMetError):
    """A static Program failed verification; ``.diagnostics`` holds the
    findings."""

    def __init__(self, message="", diagnostics=()):
        super().__init__(message)
        self.diagnostics = list(diagnostics)


def enforce(cond, msg="", exc=InvalidArgumentError):
    """PADDLE_ENFORCE parity: raise typed error when cond is false."""
    if not cond:
        raise exc(msg() if callable(msg) else msg)


def enforce_eq(a, b, msg="", exc=InvalidArgumentError):
    if a != b:
        raise exc(f"Expected {a!r} == {b!r}. {msg() if callable(msg) else msg}")


def enforce_not_none(v, name="value", exc=NotFoundError):
    if v is None:
        raise exc(f"{name} must not be None")
    return v


def with_op_hint(e: Exception, op_name: str) -> Exception:
    """Append the op attribution hint on failure (tracer.cc:188 analog)."""
    hint = f"  [operator < {op_name} > error]"
    if e.args and isinstance(e.args[0], str) and hint not in e.args[0]:
        e.args = (e.args[0] + "\n" + hint,) + e.args[1:]
    elif not e.args:
        e.args = (hint,)
    return e
