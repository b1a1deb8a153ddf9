"""Each ported op against its paddle_tpu counterpart on seeded inputs,
one case an op: integer, logic and manipulation results exactly, float
math at rtol 1e-5 (atol 1e-6 near zero).  Integer results are compared
by value (the port's indices are int64, paddle_tpu's int32).  The
random ops draw other streams by design: their cases hold shapes,
dtypes, ranges, moments and the stream under one seed."""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement

rs = np.random.RandomState(0)
A = rs.randn(3, 4).astype(np.float32)
B = rs.randn(3, 4).astype(np.float32)
POS = (rs.rand(3, 4) + 0.5).astype(np.float32)
UNIT = (rs.rand(3, 4) * 1.6 - 0.8).astype(np.float32)
M = rs.randn(4, 4).astype(np.float32)
SPD = (M @ M.T + 4 * np.eye(4)).astype(np.float32)
V3 = rs.randn(2, 3).astype(np.float32)
W3 = rs.randn(2, 3).astype(np.float32)
IMG = rs.randn(1, 2, 4, 5).astype(np.float32)
INT = rs.randint(-5, 6, (3, 4)).astype(np.int64)
IDX = np.array([2, 0, 1], np.int64)
COL = rs.randint(0, 4, (3, 2)).astype(np.int64)
SEQ = np.sort(rs.randn(6)).astype(np.float32)
BOOL = rs.rand(3, 4) > 0.5

# name -> (kind, fn(p, t)); ``t`` makes the package's tensor from numpy
FLOAT, EXACT = "float", "exact"
CASES = {
    # -- math: elementwise -------------------------------------------------
    **{n: (FLOAT, (lambda n: lambda p, t: getattr(p, n)(t(A), t(B)))(n))
       for n in ("add", "subtract", "multiply", "divide", "maximum",
                 "minimum", "fmax", "fmin", "atan2", "hypot", "logaddexp")},
    "floor_divide": (EXACT, lambda p, t: p.floor_divide(t(INT), t(
        np.full_like(INT, 3)))),
    "remainder": (EXACT, lambda p, t: p.remainder(t(INT), t(
        np.full_like(INT, 3)))),
    **{n: (FLOAT, (lambda n: lambda p, t: getattr(p, n)(t(A)))(n))
       for n in ("exp", "expm1", "square", "abs", "sign", "neg", "floor",
                 "ceil", "round", "trunc", "frac", "sin", "cos", "tan",
                 "atan", "sinh", "cosh", "tanh", "asinh", "erf", "sigmoid",
                 "isnan", "isinf", "isfinite", "rad2deg", "deg2rad")},
    **{n: (FLOAT, (lambda n: lambda p, t: getattr(p, n)(t(POS)))(n))
       for n in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt",
                 "reciprocal", "digamma", "lgamma", "acosh")},
    **{n: (FLOAT, (lambda n: lambda p, t: getattr(p, n)(t(UNIT)))(n))
       for n in ("asin", "acos", "atanh", "erfinv")},
    "pow": (FLOAT, lambda p, t: p.pow(t(POS), 1.5)),
    "scale": (FLOAT, lambda p, t: p.scale(t(A), 2.0, 0.5,
                                           bias_after_scale=False)),
    "clip": (FLOAT, lambda p, t: p.clip(t(A), -0.5, 0.5)),
    "lerp": (FLOAT, lambda p, t: p.lerp(t(A), t(B), 0.3)),
    "stanh": (FLOAT, lambda p, t: p.stanh(t(A))),
    "multiplex": (FLOAT, lambda p, t: p.multiplex(
        [t(A), t(B)], t(np.array([[0], [1], [0]], np.int64)))),
    "nan_to_num": (FLOAT, lambda p, t: p.nan_to_num(t(np.array(
        [np.nan, np.inf, -np.inf, 1.0], np.float32)), posinf=9.0,
        neginf=-9.0)),
    "add_n": (FLOAT, lambda p, t: p.add_n([t(A), t(B), t(A)])),
    # -- math: products ------------------------------------------------------
    "matmul": (FLOAT, lambda p, t: p.matmul(t(A), t(B), transpose_y=True)),
    "matmul_tx": (FLOAT, lambda p, t: p.matmul(t(A), t(B),
                                                transpose_x=True)),
    "bmm": (FLOAT, lambda p, t: p.bmm(t(A[None]), t(B.T[None]))),
    "dot": (FLOAT, lambda p, t: p.dot(t(A), t(B))),
    "inner": (FLOAT, lambda p, t: p.inner(t(A), t(B))),
    "outer": (FLOAT, lambda p, t: p.outer(t(A[0]), t(B[1]))),
    "addmm": (FLOAT, lambda p, t: p.addmm(t(M), t(M), t(M), 0.5, 2.0)),
    "kron": (FLOAT, lambda p, t: p.kron(t(V3), t(W3))),
    "cross": (FLOAT, lambda p, t: p.cross(t(V3), t(W3))),
    "einsum": (FLOAT, lambda p, t: p.einsum("ij,kj->ik", t(A), t(B))),
    "mv": (FLOAT, lambda p, t: p.mv(t(A), t(B[0]))),
    "cumsum": (FLOAT, lambda p, t: p.cumsum(t(A), axis=1)),
    "cumsum_flat": (FLOAT, lambda p, t: p.cumsum(t(A))),
    "cumprod": (FLOAT, lambda p, t: p.cumprod(t(A), dim=0)),
    "cummax": (FLOAT, lambda p, t: p.cummax(t(A), axis=1)),
    "logcumsumexp": (FLOAT, lambda p, t: p.logcumsumexp(t(A), axis=1)),
    "trace": (FLOAT, lambda p, t: p.trace(t(M), offset=1)),
    # -- reductions ------------------------------------------------------------
    **{n: (FLOAT, (lambda n: lambda p, t: getattr(p, n)(
        t(A), axis=1, keepdim=True))(n))
       for n in ("sum", "mean", "max", "min", "amax", "amin", "logsumexp",
                 "median", "nanmean", "nansum")},
    "sum_all": (FLOAT, lambda p, t: p.sum(t(A))),
    "mean_all": (FLOAT, lambda p, t: p.mean(t(A))),
    "max_axes": (FLOAT, lambda p, t: p.max(t(IMG), axis=[1, 3])),
    "prod": (FLOAT, lambda p, t: p.prod(t(POS), axis=[0, 1])),
    "std": (FLOAT, lambda p, t: p.std(t(A), axis=0)),
    "var": (FLOAT, lambda p, t: p.var(t(A), unbiased=False)),
    "median_even": (FLOAT, lambda p, t: p.median(t(A), axis=1)),
    "argmax": (EXACT, lambda p, t: p.argmax(t(A), axis=1)),
    "argmin": (EXACT, lambda p, t: p.argmin(t(A))),
    "all": (EXACT, lambda p, t: p.all(t(BOOL), axis=0)),
    "any": (EXACT, lambda p, t: p.any(t(BOOL), axis=1)),
    "count_nonzero": (EXACT, lambda p, t: p.count_nonzero(t(INT), axis=1)),
    # -- manipulation ----------------------------------------------------------
    "cast": (EXACT, lambda p, t: p.cast(t(A * 3), "int32")),
    "reshape": (EXACT, lambda p, t: p.reshape(t(A), [2, -1])),
    "transpose": (EXACT, lambda p, t: p.transpose(t(IMG), [3, 1, 0, 2])),
    "t": (EXACT, lambda p, t: p.t(t(A))),
    "moveaxis": (EXACT, lambda p, t: p.moveaxis(t(IMG), 1, 3)),
    "swapaxes": (EXACT, lambda p, t: p.swapaxes(t(IMG), 0, 2)),
    "flatten": (EXACT, lambda p, t: p.flatten(t(IMG), 1, 2)),
    "squeeze": (EXACT, lambda p, t: p.squeeze(t(IMG), [0, 1])),
    "unsqueeze": (EXACT, lambda p, t: p.unsqueeze(t(A), [0, 2])),
    "concat": (EXACT, lambda p, t: p.concat([t(A), t(B)], axis=1)),
    "stack": (EXACT, lambda p, t: p.stack([t(A), t(B)], axis=2)),
    "split": (EXACT, lambda p, t: p.split(t(A), [1, -1, 2], axis=1)),
    "split_equal": (EXACT, lambda p, t: p.split(t(A), 2, axis=1)),
    "chunk": (EXACT, lambda p, t: p.chunk(t(A), 2, axis=1)),
    "unbind": (EXACT, lambda p, t: p.unbind(t(A), axis=1)),
    "tile": (EXACT, lambda p, t: p.tile(t(A), [2, 1, 3])),
    "expand": (EXACT, lambda p, t: p.expand(t(A[:1]), [2, 3, -1])),
    "expand_as": (EXACT, lambda p, t: p.expand_as(t(A[:1]), t(A))),
    "broadcast_to": (EXACT, lambda p, t: p.broadcast_to(t(A[0]), [2, 4])),
    "broadcast_tensors": (EXACT, lambda p, t: p.broadcast_tensors(
        [t(A[:1]), t(B[:, :1])])),
    "flip": (EXACT, lambda p, t: p.flip(t(A), [0, 1])),
    "rot90": (EXACT, lambda p, t: p.rot90(t(A), 3)),
    "roll": (EXACT, lambda p, t: p.roll(t(A), 2, axis=1)),
    "roll_flat": (EXACT, lambda p, t: p.roll(t(A), -5)),
    "repeat_interleave": (EXACT, lambda p, t: p.repeat_interleave(
        t(A), 2, axis=0)),
    "gather": (EXACT, lambda p, t: p.gather(t(A), t(IDX))),
    "gather_axis1": (EXACT, lambda p, t: p.gather(t(A), t(IDX), axis=1)),
    "gather_nd": (EXACT, lambda p, t: p.gather_nd(t(A), t(np.array(
        [[0, 1], [2, 3]], np.int64)))),
    "take_along_axis": (EXACT, lambda p, t: p.take_along_axis(
        t(A), t(COL), 1)),
    "put_along_axis": (EXACT, lambda p, t: p.put_along_axis(
        t(A), t(COL[:, :1]), 9.0, 1)),
    "put_along_axis_add": (FLOAT, lambda p, t: p.put_along_axis(
        t(A), t(COL), t(B[:, :2]), 1, reduce="add")),
    "scatter": (EXACT, lambda p, t: p.scatter(t(A), t(IDX[:2]), t(B[:2]))),
    "scatter_accumulate": (FLOAT, lambda p, t: p.scatter(
        t(A), t(np.array([1, 1], np.int64)), t(B[:2]), overwrite=False)),
    "scatter_nd_add": (FLOAT, lambda p, t: p.scatter_nd_add(
        t(A), t(np.array([[0, 1], [0, 1], [2, 2]], np.int64)),
        t(B[0, :3]))),
    "scatter_nd": (FLOAT, lambda p, t: p.scatter_nd(
        t(np.array([[1], [2]], np.int64)), t(B[:2]), [4, 4])),
    "index_select": (EXACT, lambda p, t: p.index_select(t(A), t(IDX),
                                                         axis=0)),
    "index_sample": (EXACT, lambda p, t: p.index_sample(t(A), t(COL))),
    "masked_select": (EXACT, lambda p, t: p.masked_select(t(A), t(BOOL))),
    "masked_fill": (EXACT, lambda p, t: p.masked_fill(t(A), t(BOOL), -1.0)),
    "where": (EXACT, lambda p, t: p.where(t(BOOL), t(A), t(B))),
    "where_one_arg": (EXACT, lambda p, t: p.where(t(BOOL))),
    "nonzero": (EXACT, lambda p, t: p.nonzero(t(INT))),
    "pad_constant": (EXACT, lambda p, t: p.pad(t(IMG), [1, 2, 0, 1],
                                               value=3.0)),
    "pad_full": (EXACT, lambda p, t: p.pad(t(A), [1, 0, 2, 1])),
    "pad_reflect": (EXACT, lambda p, t: p.pad(t(IMG), [1, 1, 2, 0],
                                              mode="reflect")),
    "pad_replicate": (EXACT, lambda p, t: p.pad(t(IMG), [2, 1, 1, 1],
                                                mode="replicate")),
    "sort": (EXACT, lambda p, t: p.sort(t(A), axis=0, descending=True)),
    "argsort": (EXACT, lambda p, t: p.argsort(t(A), axis=1)),
    "topk": (EXACT, lambda p, t: p.topk(t(A), 2, axis=1, largest=False)),
    "kthvalue": (EXACT, lambda p, t: p.kthvalue(t(A), 2, axis=1)),
    "mode": (EXACT, lambda p, t: p.mode(t(INT), axis=1)[0]),
    "unique": (EXACT, lambda p, t: p.unique(t(INT), return_index=True,
                                            return_counts=True)),
    "searchsorted": (EXACT, lambda p, t: p.searchsorted(t(SEQ), t(A[0]))),
    "bucketize": (EXACT, lambda p, t: p.bucketize(t(A[0]), t(SEQ),
                                                  right=True)),
    "one_hot": (EXACT, lambda p, t: p.nn.functional.one_hot(t(IDX), 4)),
    "diff": (EXACT, lambda p, t: p.diff(t(A), axis=1)),
    "getitem": (EXACT, lambda p, t: t(A)[1:, ::2]),
    "slice": (EXACT, lambda p, t: p.slice(t(IMG), [2, 3], [1, -4],
                                          [3, 100])),
    "strided_slice": (EXACT, lambda p, t: p.strided_slice(
        t(IMG), [2, 3], [0, 4], [4, 0], [2, -2])),
    "crop_tensor": (EXACT, lambda p, t: p.crop_tensor(t(A), [2, 2],
                                                      [1, 1])),
    "shard_index": (EXACT, lambda p, t: p.shard_index(
        t(np.arange(10, dtype=np.int64)[:, None]), 10, 3, 1)),
    # -- logic ---------------------------------------------------------------
    **{n: (EXACT, (lambda n: lambda p, t: getattr(p, n)(t(A), t(B)))(n))
       for n in ("equal", "not_equal", "greater_than", "greater_equal",
                 "less_than", "less_equal")},
    **{n: (EXACT, (lambda n: lambda p, t: getattr(p, n)(
        t(BOOL), t(~BOOL[::-1])))(n))
       for n in ("logical_and", "logical_or", "logical_xor")},
    **{n: (EXACT, (lambda n: lambda p, t: getattr(p, n)(t(INT), t(
        INT[::-1].copy())))(n))
       for n in ("bitwise_and", "bitwise_or", "bitwise_xor")},
    "logical_not": (EXACT, lambda p, t: p.logical_not(t(BOOL))),
    "bitwise_not": (EXACT, lambda p, t: p.bitwise_not(t(INT))),
    "isclose": (EXACT, lambda p, t: p.isclose(t(A), t(A + 1e-7))),
    "allclose": (EXACT, lambda p, t: p.allclose(t(A), t(B))),
    "equal_all": (EXACT, lambda p, t: p.equal_all(t(A), t(A))),
    "isin": (EXACT, lambda p, t: p.isin(t(INT), t(IDX))),
    "is_empty": (EXACT, lambda p, t: p.is_empty(t(A))),
    # -- linalg --------------------------------------------------------------
    "norm": (FLOAT, lambda p, t: p.norm(t(A))),
    "norm_p1_axis": (FLOAT, lambda p, t: p.norm(t(A), p=1, axis=1)),
    "norm_inf": (FLOAT, lambda p, t: p.norm(t(A), p=float("inf"), axis=0)),
    "dist": (FLOAT, lambda p, t: p.dist(t(A), t(B), p=3)),
    "cholesky": (FLOAT, lambda p, t: p.linalg.cholesky(t(SPD))),
    "inverse": (FLOAT, lambda p, t: p.linalg.inverse(t(SPD))),
    "det": (FLOAT, lambda p, t: p.linalg.det(t(SPD))),
    "slogdet": (FLOAT, lambda p, t: p.linalg.slogdet(t(SPD))),
    "solve": (FLOAT, lambda p, t: p.linalg.solve(t(SPD), t(M))),
    "matrix_power": (FLOAT, lambda p, t: p.linalg.matrix_power(t(M), 3)),
    "eigvalsh": (FLOAT, lambda p, t: p.linalg.eigvalsh(t(SPD))),
    "pinv": (FLOAT, lambda p, t: p.linalg.pinv(t(A))),
    "triangular_solve": (FLOAT, lambda p, t: p.linalg.triangular_solve(
        t(np.triu(SPD)), t(M))),
    "cov": (FLOAT, lambda p, t: p.linalg.cov(t(A))),
    "corrcoef": (FLOAT, lambda p, t: p.linalg.corrcoef(t(A))),
    "matrix_rank": (EXACT, lambda p, t: p.linalg.matrix_rank(t(SPD))),
    "bincount": (EXACT, lambda p, t: p.linalg.bincount(t(IDX))),
    # -- creation --------------------------------------------------------------
    "eye": (EXACT, lambda p, t: p.eye(3, 4)),
    "linspace": (FLOAT, lambda p, t: p.linspace(-1, 2, 7)),
    "logspace": (FLOAT, lambda p, t: p.logspace(0, 2, 5)),
    "full": (EXACT, lambda p, t: p.full([2, 3], 1.5)),
    "diag": (EXACT, lambda p, t: p.diag(t(A[0]), offset=1,
                                        padding_value=7.0)),
    "diag_of_matrix": (EXACT, lambda p, t: p.diag(t(M), offset=-1)),
    "diagflat": (EXACT, lambda p, t: p.diagflat(t(V3))),
    "tril": (EXACT, lambda p, t: p.tril(t(M), -1)),
    "triu": (EXACT, lambda p, t: p.triu(t(M), 1)),
    "clone": (EXACT, lambda p, t: p.clone(t(A))),
    "numel": (EXACT, lambda p, t: p.numel(t(A))),
    "rank": (EXACT, lambda p, t: p.rank(t(IMG))),
    "shape": (EXACT, lambda p, t: p.shape(t(IMG))),
}


def _np(out):
    if isinstance(out, (list, tuple)):
        return [_np(o) for o in out]
    return np.asarray(out.numpy() if hasattr(out, "numpy") else out)


def _compare(a, b, kind):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _compare(x, y, kind)
        return
    assert a.shape == b.shape, (a.shape, b.shape)
    if kind == EXACT:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_paddle_tpu(cpu, name):
    kind, fn = CASES[name]
    want = _np(fn(paddle_tpu, paddle_tpu.to_tensor))
    got_t = fn(cpu, cpu.to_tensor)
    for t in (got_t if isinstance(got_t, (list, tuple)) else [got_t]):
        assert isinstance(t, cpu.Tensor), type(t)
    _compare(_np(got_t), want, kind)


@pytest.mark.parametrize("name", ["add", "exp", "sum", "mean", "matmul",
                                  "reshape", "transpose", "concat",
                                  "gather", "where", "clip", "max"])
def test_op_gradient_matches_paddle_tpu(cpu, name):
    """The gradient of the op's summed output with respect to its first
    float input, in both packages."""
    kind, fn = CASES[name]
    grads = []
    for p in (paddle_tpu, cpu):
        first = []

        def t(a, p=p, first=first):
            x = p.to_tensor(a, stop_gradient=bool(
                first or a.dtype != np.float32))
            if not x.stop_gradient:
                first.append(x)
            return x
        out = fn(p, t)
        p.sum(out * out).backward()
        grads.append(first[0].grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-6)


RANDOM = {
    "rand": lambda p: p.rand([400, 5]),
    "randn": lambda p: p.randn([400, 5]),
    "uniform": lambda p: p.uniform([400, 5], min=-2.0, max=3.0),
    "normal": lambda p: p.normal(1.0, 2.0, [400, 5]),
    "standard_normal": lambda p: p.standard_normal([400, 5]),
    "randint": lambda p: p.randint(2, 9, [400, 5]),
    "randint_like": lambda p: p.randint_like(p.ones([400, 5]), 0, 4),
    "randperm": lambda p: p.randperm(50),
    "shuffle": lambda p: p.shuffle(p.arange(50)),
    "bernoulli": lambda p: p.bernoulli(p.full([400, 5], 0.3)),
    "poisson": lambda p: p.poisson(p.full([400, 5], 2.0)),
    "multinomial": lambda p: p.multinomial(p.to_tensor(
        np.array([[0.1, 0.2, 0.7]] * 50, np.float32)), 3),
}
# the draw's (mean, low, high) per op (None: not held)
MOMENTS = {"rand": (0.5, 0, 1), "randn": (0.0, None, None),
           "uniform": (0.5, -2, 3), "normal": (1.0, None, None),
           "standard_normal": (0.0, None, None), "randint": (5.0, 2, 8),
           "randint_like": (1.5, 0, 3), "randperm": (24.5, 0, 49),
           "shuffle": (24.5, 0, 49), "bernoulli": (0.3, 0, 1),
           "poisson": (2.0, 0, None), "multinomial": (1.0, 0, 2)}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_op_shape_dtype_range_and_stream(cpu, name):
    if name == "poisson":   # paddle_tpu's needs threefry; it runs rbg
        want = np.random.RandomState(0).poisson(2.0, (400, 5)).astype(
            np.float32)
    else:
        want = np.asarray(RANDOM[name](paddle_tpu).numpy())
    cpu.seed(11)
    a = RANDOM[name](cpu).numpy()
    cpu.seed(11)
    b = RANDOM[name](cpu).numpy()
    np.testing.assert_array_equal(a, b)          # same seed, same stream
    assert a.shape == want.shape
    assert a.dtype.kind == want.dtype.kind
    mean, lo, hi = MOMENTS[name]
    if lo is not None:
        assert a.min() >= lo
    if hi is not None:
        assert a.max() <= hi
    scale = max(1.0, abs(mean), float(np.std(want)))
    assert abs(a.mean() - mean) < 0.15 * scale
    if name in ("randperm", "shuffle"):
        np.testing.assert_array_equal(np.sort(a), np.arange(50))
