"""Process-wide stat gauges and histograms.

Reference: paddle/fluid/platform/monitor.h StatRegistry / STAT_ADD —
integer/float gauges keyed by name, readable for logging and tests.
Histograms (``stat_observe`` / ``quantile``) use fixed log-spaced
buckets for latency-style distributions; the engines' ``stats()`` and
the HTTP ``/metrics`` payload are built on them.  Same bucket layout
and quantile estimate as ``paddle_tpu.utils.monitor``.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Union

__all__ = ["StatRegistry", "get_stat", "stat_add", "stat_set",
           "stat_reset", "all_stats", "stat_observe", "quantile",
           "histogram_summary", "all_histograms", "histogram_raw",
           "quantile_from_counts"]

# Histogram bucket layout: log-spaced, 8 buckets per decade covering
# [1e-3, 1e7) — sub-microsecond to ~3 hours when observing milliseconds.
# Values outside the range clamp into the edge buckets; exact min/max/sum
# are tracked separately so the summary never lies about the extremes.
_H_LO_EXP = -3
_H_HI_EXP = 7
_H_PER_DECADE = 8
_H_NBUCKETS = (_H_HI_EXP - _H_LO_EXP) * _H_PER_DECADE


def _bucket_index(v: float) -> int:
    if v <= 10.0 ** _H_LO_EXP:
        return 0
    if v >= 10.0 ** _H_HI_EXP:
        return _H_NBUCKETS - 1
    return min(_H_NBUCKETS - 1,
               int((math.log10(v) - _H_LO_EXP) * _H_PER_DECADE))


def _bucket_bounds(i: int):
    lo = 10.0 ** (_H_LO_EXP + i / _H_PER_DECADE)
    hi = 10.0 ** (_H_LO_EXP + (i + 1) / _H_PER_DECADE)
    return lo, hi


class _Histogram:
    __slots__ = ("counts", "n", "total", "vmin", "vmax")

    def __init__(self):
        self.counts: List[int] = [0] * _H_NBUCKETS
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float):
        self.counts[_bucket_index(v)] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0 <= q <= 1) from the buckets:
        linear by rank inside the bucket holding rank ``q*n``, clamped
        to the exactly tracked [min, max]."""
        if self.n == 0:
            return 0.0
        if q <= 0.0:
            return self.vmin
        if q >= 1.0:
            return self.vmax
        rank = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            prev, seen = seen, seen + c
            if c and seen >= rank:
                lo, hi = _bucket_bounds(i)
                est = lo + (hi - lo) * ((rank - prev) / c)
                return min(max(est, self.vmin), self.vmax)
        return self.vmax

    def raw(self) -> Dict[str, object]:
        """Cumulative bucket counts and exact aggregates: two raws taken
        at different times subtract bucket-wise into the distribution of
        the interval between them."""
        return {"counts": tuple(self.counts), "count": self.n,
                "sum": self.total,
                "min": self.vmin if self.n else 0.0,
                "max": self.vmax if self.n else 0.0}

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.n,
            "sum": self.total,
            "mean": (self.total / self.n) if self.n else 0.0,
            "min": self.vmin if self.n else 0.0,
            "max": self.vmax if self.n else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class StatRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Union[int, float]] = {}
        self._hists: Dict[str, _Histogram] = {}

    def add(self, name: str, v: Union[int, float] = 1):
        with self._lock:
            self._stats[name] = self._stats.get(name, 0) + v
            return self._stats[name]

    def set(self, name: str, v: Union[int, float]):
        with self._lock:
            self._stats[name] = v

    def get(self, name: str) -> Union[int, float]:
        with self._lock:
            return self._stats.get(name, 0)

    def reset(self, name: str = None):
        with self._lock:
            if name is None:
                self._stats.clear()
                self._hists.clear()
            else:
                self._stats.pop(name, None)
                self._hists.pop(name, None)

    def snapshot(self) -> Dict[str, Union[int, float]]:
        with self._lock:
            return dict(self._stats)

    def observe(self, name: str, v: float):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram()
            h.observe(float(v))

    def quantile(self, name: str, q: float) -> float:
        with self._lock:
            h = self._hists.get(name)
            return h.quantile(q) if h is not None else 0.0

    def histogram_summary(self, name: str) -> Dict[str, float]:
        with self._lock:
            h = self._hists.get(name)
            return h.summary() if h is not None else _Histogram().summary()

    def histogram_raw(self, name: str):
        """Cumulative bucket counts for ``name`` (None if unobserved)."""
        with self._lock:
            h = self._hists.get(name)
            return h.raw() if h is not None else None

    def histograms(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: h.summary() for k, h in self._hists.items()}


_default = StatRegistry()


def get_stat(name):
    return _default.get(name)


def stat_add(name, v=1):
    return _default.add(name, v)


def stat_set(name, v):
    _default.set(name, v)


def stat_reset(name=None):
    """Forget counter and histogram ``name``, or everything."""
    _default.reset(name)


def all_stats():
    """Every counter (histograms not included)."""
    return _default.snapshot()


def stat_observe(name, v):
    """Record one sample into the log-bucketed histogram ``name``."""
    _default.observe(name, v)


def quantile(name, q):
    """Estimated q-quantile of histogram ``name`` (0.0 if unobserved)."""
    return _default.quantile(name, q)


def histogram_summary(name):
    """count/sum/mean/min/max/p50/p95/p99 for histogram ``name``."""
    return _default.histogram_summary(name)


def all_histograms():
    return _default.histograms()


def histogram_raw(name):
    """Cumulative bucket counts and aggregates of histogram ``name``
    (None if it was never observed)."""
    return _default.histogram_raw(name)


def quantile_from_counts(counts, n: int, q: float,
                         vmin=None, vmax=None) -> float:
    """q-quantile of a raw bucket-count vector (e.g. the difference of
    two :func:`histogram_raw` snapshots), by the same rank-linear
    interpolation as a histogram's, clamped to ``[vmin, vmax]`` where
    given (a window's values lie within the histogram's cumulative
    extremes)."""
    if n <= 0:
        return 0.0
    rank = min(max(q, 0.0), 1.0) * n
    seen = 0
    last = 0
    est = None
    for i, c in enumerate(counts):
        if not c:
            continue
        last = i
        prev, seen = seen, seen + c
        if seen >= rank:
            lo, hi = _bucket_bounds(i)
            est = lo + (hi - lo) * (max(rank - prev, 0.0) / c)
            break
    if est is None:
        est = _bucket_bounds(last)[1]
    if vmax is not None:
        est = min(est, vmax)
    if vmin is not None:
        est = max(est, vmin)
    return est
