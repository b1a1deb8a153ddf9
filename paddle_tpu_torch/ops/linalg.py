"""Linear algebra (``paddle_tpu.ops.linalg``), on ``torch.linalg``."""
from __future__ import annotations

import torch

from ..core.dispatch import apply

__all__ = ["norm", "dist", "cholesky", "inverse", "pinv", "matrix_power",
           "matrix_rank", "slogdet", "det", "qr", "svd", "eigh", "eigvalsh",
           "solve", "triangular_solve", "lstsq", "matmul_transpose", "cov",
           "corrcoef", "histogram", "bincount"]


def _norm(a, *, p, axis, keepdim):
    if axis is None and p in ("fro", 2):
        return torch.sqrt(torch.sum(torch.square(a)))
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if ax is None:
        ax = tuple(range(a.dim()))
    if p == "fro":
        return torch.sqrt(torch.sum(torch.square(a), ax, keepdim=keepdim))
    if p == float("inf"):
        return torch.amax(torch.abs(a), ax, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(a), ax, keepdim=keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), ax, keepdim=keepdim)
    return torch.sum(torch.abs(a) ** p, ax, keepdim=keepdim) ** (1.0 / p)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    return apply(_norm, x, op_name="norm",
                 attrs={"p": p, "axis": axis, "keepdim": bool(keepdim)})


def _dist(a, b, *, p):
    d = a - b
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == float("-inf"):
        return torch.amin(torch.abs(d))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    return apply(_dist, x, y, op_name="dist", attrs={"p": p})


def _cholesky(a, *, upper):
    out = torch.linalg.cholesky(a)
    return out.transpose(-1, -2) if upper else out


def cholesky(x, upper=False, name=None):
    return apply(_cholesky, x, op_name="cholesky", attrs={"upper": upper})


def inverse(x, name=None):
    return apply(torch.linalg.inv, x, op_name="inverse")


def _pinv(a, *, rcond, hermitian):
    return torch.linalg.pinv(a, rtol=rcond, hermitian=hermitian)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply(_pinv, x, op_name="pinv",
                 attrs={"rcond": rcond, "hermitian": hermitian})


def _matrix_power(a, *, n):
    return torch.linalg.matrix_power(a, n)


def matrix_power(x, n, name=None):
    return apply(_matrix_power, x, op_name="matrix_power", attrs={"n": n})


def _matrix_rank(a, *, tol):
    return torch.linalg.matrix_rank(a, atol=tol)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply(_matrix_rank, x, op_name="matrix_rank", attrs={"tol": tol})


def _slogdet(a):
    return tuple(torch.linalg.slogdet(a))


def slogdet(x, name=None):
    return apply(_slogdet, x, op_name="slogdet")


def det(x, name=None):
    return apply(torch.linalg.det, x, op_name="det")


def _qr(a, *, mode):
    return tuple(torch.linalg.qr(a, mode=mode))


def qr(x, mode="reduced", name=None):
    return apply(_qr, x, op_name="qr", attrs={"mode": mode})


def _svd(a, *, full_matrices):
    return tuple(torch.linalg.svd(a, full_matrices=full_matrices))


def svd(x, full_matrices=False, name=None):
    return apply(_svd, x, op_name="svd",
                 attrs={"full_matrices": full_matrices})


def _eigh(a, *, UPLO):
    return tuple(torch.linalg.eigh(a, UPLO=UPLO))


def eigh(x, UPLO="L", name=None):
    return apply(_eigh, x, op_name="eigh", attrs={"UPLO": UPLO})


def _eigvalsh(a, *, UPLO):
    return torch.linalg.eigvalsh(a, UPLO=UPLO)


def eigvalsh(x, UPLO="L", name=None):
    return apply(_eigvalsh, x, op_name="eigvalsh", attrs={"UPLO": UPLO})


def solve(x, y, name=None):
    return apply(torch.linalg.solve, x, y, op_name="solve")


def _triangular_solve(a, b, *, upper, transpose, unitriangular):
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return apply(_triangular_solve, x, y, op_name="triangular_solve",
                 attrs={"upper": upper, "transpose": transpose,
                        "unitriangular": unitriangular})


def _lstsq(a, b, *, rcond):
    r = torch.linalg.lstsq(a, b, rcond=rcond)
    return r.solution, r.residuals, r.rank, r.singular_values


def lstsq(x, y, rcond=None, driver=None, name=None):
    return apply(_lstsq, x, y, op_name="lstsq", attrs={"rcond": rcond})


def _matmul_transpose(a, b):
    return torch.matmul(a, b.transpose(-1, -2))


def matmul_transpose(x, y):
    return apply(_matmul_transpose, x, y, op_name="matmul_transpose")


def _cov(a, *, rowvar, ddof):
    return torch.cov(a if rowvar else a.transpose(0, 1),
                     correction=1 if ddof else 0)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply(_cov, x, op_name="cov",
                 attrs={"rowvar": rowvar, "ddof": bool(ddof)})


def _corrcoef(a, *, rowvar):
    return torch.corrcoef(a if rowvar else a.transpose(0, 1))


def corrcoef(x, rowvar=True, name=None):
    return apply(_corrcoef, x, op_name="corrcoef", attrs={"rowvar": rowvar})


def _histogram(a, *, bins, lo, hi):
    if lo == 0 and hi == 0:
        lo, hi = a.min().item(), a.max().item()
    return torch.histc(a.float(), bins=bins, min=lo, max=hi).to(torch.int64)


def histogram(x, bins=100, min=0, max=0, name=None):
    return apply(_histogram, x, op_name="histogram",
                 attrs={"bins": int(bins), "lo": min, "hi": max})


def _bincount(a, *, minlength):
    return torch.bincount(a, minlength=minlength)


def bincount(x, weights=None, minlength=0, name=None):
    return apply(_bincount, x, op_name="bincount",
                 attrs={"minlength": int(minlength)})
