"""Hazard passes (the counterpart of
``paddle_tpu/static/analysis/hazards.py``), restated for the card.

The verifier passes (:mod:`.passes`) prove a Program well-formed; these
flag what makes a well-formed program run worse than it reads.  Each is
an :class:`~.passes.AnalysisPass` emitting the same :class:`Diagnostic`
records, so ``check``/``verify`` and ``Program.analyze`` surface them.
Severity: data baked into the program is an error, a cost or precision
surprise a warning, a note an info.  The pass names and severities are
the JAX package's.

- **host-transfer**: an eager tensor or numpy array captured as an op's
  constant.  The Executor holds it on the card as part of the step, as
  the JAX package freezes it into the executable: it forks from the live
  host value, checkpoints do not see it, and a program rebuilt with
  another value builds its step again.  A recorded host-sync op
  (``numpy``, ``item``, ``tolist``) stalls the card's queue every run.
- **wide-dtype**: float64 and complex128 Variables.  On the card they
  stay 64-bit (torch does not narrow them, unlike the JAX runtime
  without x64): twice the bytes of float32, and float64 arithmetic runs
  well below the float32 rate.  int64 stays int64 in the port, as it
  runs (a kept difference of the eager core), so the JAX pass's int64 info
  (narrowed to int32 there) has no counterpart and the pass is silent
  on integers.
- **donation-alias**: distinct Parameters sharing one storage (weights
  tied by aliasing).  The Executor updates each parameter in place, so
  the shared storage takes every alias's update a step.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .graph import DefUseGraph
from .liveness import aval_bytes
from .passes import AnalysisPass, Diagnostic

__all__ = ["HostTransferPass", "WideDtypePass", "DonationAliasPass",
           "hazard_passes", "HAZARD_PASS_REGISTRY"]

# a captured constant this large is training data riding the program
_CONST_ERROR_BYTES = 1 << 20
# above this it is worth a warning
_CONST_WARN_BYTES = 4 << 10

_HOST_SYNC_OPS = frozenset({"numpy", "item", "tolist", "asnumpy"})


class HostTransferPass(AnalysisPass):
    """Captured constants and host-sync points."""

    name = "host-transfer"

    def run(self, graph: DefUseGraph, fetch_list=None) -> List[Diagnostic]:
        out: List[Diagnostic] = []
        for i, node in enumerate(graph.nodes):
            if node.op_name in _HOST_SYNC_OPS:
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"op '{node.op_name}' forces a device->host sync "
                    f"every run, stalling the card's queue; fetch the "
                    f"value through fetch_list instead", op_index=i))
            for tag, x in node.in_specs:
                if not (tag == "c" or (tag == "l"
                                       and isinstance(x, np.ndarray))):
                    continue
                nb = aval_bytes(x)
                if nb >= _CONST_ERROR_BYTES:
                    sev, why = Diagnostic.ERROR, (
                        "baked into the step: tensor data riding the "
                        "program, held on the card for its life and "
                        "invisible to checkpoints")
                elif nb >= _CONST_WARN_BYTES:
                    sev, why = Diagnostic.WARNING, (
                        "captured as a constant of the step; it forks "
                        "silently from the live host value")
                else:
                    sev, why = Diagnostic.INFO, (
                        "captured as a constant of the step; a program "
                        "rebuilt with another value builds its step again "
                        "- declare it with static.data and feed it "
                        "instead")
                kind = ("host ndarray" if isinstance(x, np.ndarray)
                        else "eager Tensor")
                out.append(self._diag(
                    graph, sev,
                    f"{kind} constant ({nb} bytes, shape "
                    f"{list(x.shape)}) {why}", op_index=i))
        return out


_WIDE = (torch.float64, torch.complex128)


class WideDtypePass(AnalysisPass):
    """64-bit floating Variables, which the card runs as they are."""

    name = "wide-dtype"

    def run(self, graph: DefUseGraph, fetch_list=None) -> List[Diagnostic]:
        out: List[Diagnostic] = []
        seen = set()

        def flag(v, op_index=None):
            if id(v) in seen or v.meta.dtype not in _WIDE:
                return
            seen.add(id(v))
            name = str(v.meta.dtype).replace("torch.", "")
            narrow = ("float32" if v.meta.dtype == torch.float64
                      else "complex64")
            out.append(self._diag(
                graph, Diagnostic.WARNING,
                f"Variable '{v.name}' is {name}: the card runs it as "
                f"{name}, at twice the bytes of {narrow} and well below "
                f"the float32 arithmetic rate - declare {narrow}",
                op_index=op_index, var_name=v.name))

        for v in graph.feeds.values():
            flag(v)
        for i, node in enumerate(graph.nodes):
            for v in node.out_vars:
                flag(v, op_index=i)
        return out


class DonationAliasPass(AnalysisPass):
    """Distinct Parameters aliasing one storage."""

    name = "donation-alias"

    def run(self, graph: DefUseGraph, fetch_list=None) -> List[Diagnostic]:
        out: List[Diagnostic] = []
        by_buf: dict = {}
        for plist in graph.params_of.values():
            for p in plist:
                group = by_buf.setdefault(
                    (p.device, p.untyped_storage().data_ptr()), [])
                if not any(q is p for q in group):
                    group.append(p)
        for group in by_buf.values():
            if len(group) > 1:
                names = ", ".join(repr(_pname(p)) for p in group)
                out.append(Diagnostic(
                    Diagnostic.WARNING, self.name,
                    f"{len(group)} Parameters ({names}) share one "
                    f"underlying buffer: the Executor updates each in "
                    f"place, so the buffer takes every one's update a "
                    f"step - tie weights through one Parameter object",
                    var_name=_pname(group[0])))
        return out


def _pname(p) -> str:
    return getattr(p, "param_name", None) or f"param{list(p.shape)}"


def hazard_passes() -> List[AnalysisPass]:
    """The hazard family, in reporting order."""
    return [HostTransferPass(), WideDtypePass(), DonationAliasPass()]


HAZARD_PASS_REGISTRY = {cls.name: cls for cls in (
    HostTransferPass, WideDtypePass, DonationAliasPass)}
