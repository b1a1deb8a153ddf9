"""The sparse embedding gradient (SelectedRows) of the port against
paddle_tpu's, on the CPU (the cases of ``tests/test_sparse.py``, its
sharded embedding aside): rows exactly equal, values within 1e-6; after
sparse SGD and lazy Adam the untouched rows are bitwise unchanged and
the touched ones agree with paddle_tpu's; the clips see the merged
values; the user's views (``.grad``, hooks, ``paddle.grad``) are
dense."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.core.selected_rows import SelectedRows, sparse_grad
from paddle_tpu_torch.core.tensor import raw_grad

V, D = 64, 8
IDS = np.array([[3, 9, 3], [17, 3, 40]], np.int64)


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _embeddings(sparse=True, padding_idx=None, seed=1):
    """(JAX, port) embeddings with the same numpy weights."""
    w = np.random.RandomState(seed).randn(V, D).astype("float32")
    je = paddle_tpu.nn.Embedding(V, D, sparse=sparse,
                                 padding_idx=padding_idx)
    te = paddle_tpu_torch.nn.Embedding(V, D, sparse=sparse,
                                       padding_idx=padding_idx)
    je.weight.set_value(w)
    te.weight.set_value(w)
    return je, te


def test_selected_rows_merge_dense_and_sums(cpu):
    vals = np.array([[1., 1.], [2., 2.], [3., 3.]], np.float32)
    sr, jsr = SelectedRows([2, 0, 2], vals, 4), JSR([2, 0, 2], vals, 4)
    m, jm = sr.merge(), jsr.merge()
    np.testing.assert_array_equal(m.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_allclose(m.values.numpy(), np.asarray(jm.values),
                               rtol=1e-6)
    np.testing.assert_array_equal(sr.to_dense().numpy(),
                                  np.asarray(jsr.to_dense()))
    assert sr.shape == (4, 2) and sr.dtype == torch.float32
    np.testing.assert_array_equal(sr.numpy(), jsr.numpy())
    # dense + sparse is dense; sparse + sparse concatenates; * s scales
    ones = np.ones((4, 2), np.float32)
    np.testing.assert_array_equal((ones + sr).numpy(),
                                  np.asarray(ones + jsr))
    both = sr + SelectedRows([1], np.array([[5., 5.]], np.float32), 4)
    assert isinstance(both, SelectedRows)
    np.testing.assert_array_equal(both.rows.numpy(), [2, 0, 2, 1])
    np.testing.assert_array_equal((sr * 2.0).values.numpy(), vals * 2)
    assert sr.rows.dtype == torch.int64


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_sparse_embedding_grad_is_selected_rows(cpu, padding_idx):
    """The weight's gradient holds the looked-up rows (duplicates kept,
    the padding rows with zero values); merged, its rows are exactly
    paddle_tpu's and its values within 1e-6."""
    je, te = _embeddings(padding_idx=padding_idx)
    go = np.random.RandomState(2).randn(2, 3, D).astype("float32")
    (je(paddle_tpu.to_tensor(IDS)) * paddle_tpu.to_tensor(go)).sum(
        ).backward()
    (te(paddle_tpu_torch.to_tensor(IDS))
     * paddle_tpu_torch.to_tensor(go)).sum().backward()
    assert raw_grad(te.weight).is_sparse
    g, jg = sparse_grad(raw_grad(te.weight)), je.weight._grad_data
    assert isinstance(g, SelectedRows) and isinstance(jg, JSR)
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_allclose(g.values.numpy(), np.asarray(jg.values),
                               rtol=1e-6, atol=1e-7)
    m, jm = g.merge(), jg.merge()
    np.testing.assert_array_equal(m.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_allclose(m.values.numpy(), np.asarray(jm.values),
                               rtol=1e-6, atol=1e-7)
    dense = te.weight.grad.numpy()
    np.testing.assert_allclose(dense, np.asarray(jg.to_dense()),
                               rtol=1e-6, atol=1e-7)
    untouched = np.setdiff1d(np.arange(V), IDS)
    assert np.all(dense[untouched] == 0.0)


def test_sparse_grads_accumulate(cpu):
    """Two backwards sum: the merged gradient is twice one backward's."""
    _, te = _embeddings()
    for _ in range(2):
        te(paddle_tpu_torch.to_tensor(IDS)).sum().backward()
    m = sparse_grad(raw_grad(te.weight)).merge()
    np.testing.assert_array_equal(m.rows.numpy(), [3, 9, 17, 40])
    np.testing.assert_array_equal(m.values.numpy()[:, 0], [6, 2, 2, 2])


def _train(pkg, emb, make_opt, steps=3, loss_pow=2):
    opt = make_opt(pkg.optimizer, emb.parameters())
    rs = np.random.RandomState(11)
    for k in range(steps):
        ids = IDS if k % 2 == 0 else rs.randint(0, V, (2, 4)).astype(
            "int64")
        (emb(pkg.to_tensor(ids)) ** loss_pow).sum().backward()
        opt.step()
        opt.clear_grad()
    return emb.weight.numpy(), opt


OPTS = {
    "sgd": lambda o, p: o.SGD(learning_rate=0.1, parameters=p),
    "adam_lazy": lambda o, p: o.Adam(learning_rate=0.01, lazy_mode=True,
                                     parameters=p),
    "adam_dense": lambda o, p: o.Adam(learning_rate=0.01, parameters=p),
    "momentum": lambda o, p: o.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=p),
    "sgd_l2": lambda o, p: o.SGD(learning_rate=0.1, parameters=p,
                                 weight_decay=0.5),
    "adamw_lazy": lambda o, p: o.AdamW(learning_rate=0.01, lazy_mode=True,
                                       parameters=p, weight_decay=0.1),
}


@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_sparse_updates_match(cpu, opt_name):
    """Three steps on both packages: the weights agree within 1e-6; a
    row-wise optimizer leaves untouched rows bitwise unchanged (weight
    decay skips the sparse gradient), one without a row-wise update
    takes it dense."""
    je, te = _embeddings()
    before = te.weight.numpy().copy()
    jw, _ = _train(paddle_tpu, je, OPTS[opt_name])
    tw, _ = _train(paddle_tpu_torch, te, OPTS[opt_name])
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-6)
    touched = np.zeros(V, bool)
    touched[IDS.ravel()] = True
    touched[np.random.RandomState(11).randint(0, V, (2, 4)).ravel()] = True
    if opt_name in ("sgd", "adam_lazy", "sgd_l2", "adamw_lazy"):
        np.testing.assert_array_equal(tw[~touched], before[~touched])
    assert not np.allclose(tw[touched], before[touched])


def test_lazy_adam_moments_stay_on_the_rows(cpu):
    """Lazy Adam's moments move only on the touched rows and equal
    paddle_tpu's."""
    je, te = _embeddings()
    _, jopt = _train(paddle_tpu, je, OPTS["adam_lazy"], steps=1)
    _, topt = _train(paddle_tpu_torch, te, OPTS["adam_lazy"], steps=1)
    m = topt._states[id(te.weight)]["m"].numpy()
    jm = np.asarray(jopt._slots[id(je.weight)]["m"])
    np.testing.assert_allclose(m, jm, rtol=1e-6, atol=1e-7)
    rows = np.unique(IDS)
    assert np.all(m[np.setdiff1d(np.arange(V), rows)] == 0.0)
    assert np.all(np.abs(m[rows]).sum(1) > 0)


def test_multi_precision_takes_the_sparse_gradient_dense(cpu):
    """A bf16 weight with f32 master weights updates densely, as in
    paddle_tpu: lazy Adam's rows of the first step move again in the
    second (their moments are not stale), and the weights equal
    paddle_tpu's."""
    import jax.numpy as jnp
    w = np.random.RandomState(1).randn(16, 4).astype("float32")
    got = []
    for pkg in (paddle_tpu, paddle_tpu_torch):
        e = pkg.nn.Embedding(16, 4, sparse=True)
        if pkg is paddle_tpu:
            e.weight.data = jnp.asarray(w, jnp.bfloat16)
        else:
            with torch.no_grad():
                e.weight.data = torch.tensor(w).to(torch.bfloat16)
        opt = pkg.optimizer.Adam(0.1, parameters=e.parameters(),
                                 lazy_mode=True, multi_precision=True)
        seen = []
        for ids in ([[1, 2]], [[5, 6]]):
            x = e(pkg.to_tensor(np.array(ids, np.int64)))
            (x.astype("float32") ** 2).sum().backward()
            opt.step()
            opt.clear_grad()
            seen.append(np.asarray(e.weight.astype("float32").numpy()))
        got.append(seen)
    np.testing.assert_array_equal(got[1][1], got[0][1])
    assert not np.array_equal(got[1][1][[1, 2]], got[1][0][[1, 2]])


def test_sparse_sgd_matches_dense_sgd(cpu):
    _, sparse = _embeddings(sparse=True)
    _, dense = _embeddings(sparse=False)
    a, _ = _train(paddle_tpu_torch, sparse, OPTS["sgd"])
    b, _ = _train(paddle_tpu_torch, dense, OPTS["sgd"])
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_sparse_grad_user_views_and_hooks(cpu):
    """A hook sees the dense gradient; ``.grad`` and ``paddle.grad``
    densify; the optimizer's slot stays sparse without a hook."""
    _, te = _embeddings()
    ids = paddle_tpu_torch.to_tensor(np.array([[1, 2]], np.int64))
    te(ids).sum().backward()
    assert raw_grad(te.weight).is_sparse
    g = te.weight.grad
    assert g.shape == [V, D] and not g.is_sparse
    assert float(g.numpy()[1].sum()) == D
    te.clear_gradients()
    gw, = paddle_tpu_torch.grad(te(ids).sum(), [te.weight])
    assert gw.shape == [V, D] and not gw.is_sparse
    assert raw_grad(te.weight) is None
    calls = []
    te.weight.register_hook(lambda g: calls.append((g.shape, g.is_sparse)))
    te(ids).sum().backward()
    assert calls == [([V, D], False)]
    # with a hook the gradient is deposited dense, as in paddle_tpu
    assert not raw_grad(te.weight).is_sparse


def _clip_step(pkg, emb, clip, ids):
    opt = pkg.optimizer.SGD(learning_rate=1.0, parameters=emb.parameters(),
                            grad_clip=clip)
    (emb(pkg.to_tensor(ids)).sum() * 1000.0).backward()
    opt.step()
    return emb.weight.numpy()


@pytest.mark.parametrize("clip", ["global", "norm", "value"])
def test_sparse_grad_clips_use_merged_values(cpu, clip):
    """The clips see the merged gradient: with row 1 looked up twice the
    norm is of its summed values, as in paddle_tpu."""
    make = {"global": lambda o: o.ClipGradByGlobalNorm(1e-3),
            "norm": lambda o: o.ClipGradByNorm(1e-3),
            "value": lambda o: o.ClipGradByValue(0.5)}[clip]
    ids = np.array([[1, 1, 4]], np.int64)
    je, te = _embeddings()
    for e in (je, te):        # zeros: the update is read exactly
        e.weight.set_value(np.zeros((V, D), np.float32))
    before = te.weight.numpy().copy()
    jw = _clip_step(paddle_tpu, je, make(paddle_tpu.nn), ids)
    tw = _clip_step(paddle_tpu_torch, te, make(paddle_tpu_torch.nn), ids)
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
    delta = before - tw
    if clip != "value":
        # merged: rows 1 and 4 carry 2000 and 1000 an entry, so the norm
        # is 1000 * sqrt(5 * D) and row 1 moves twice as far as row 4
        np.testing.assert_allclose(delta[1], 2 * delta[4], rtol=1e-5)
        np.testing.assert_allclose(np.sqrt((delta ** 2).sum()), 1e-3,
                                   rtol=1e-4)
    else:
        np.testing.assert_allclose(delta[[1, 4]], 0.5, rtol=1e-6)


@pytest.mark.parametrize("norm_type", [2.0, float("inf")])
def test_clip_grad_norm_(cpu, norm_type):
    """``clip_grad_norm_`` on dense gradients: the total norm and the
    scaled gradients equal paddle_tpu's."""
    rs = np.random.RandomState(7)
    a, b = rs.randn(4, 3).astype("float32"), rs.randn(5).astype("float32")
    out = []
    for pkg in (paddle_tpu, paddle_tpu_torch):
        ps = [pkg.Parameter(x.copy()) if pkg is paddle_tpu
              else pkg.Parameter(torch.tensor(x)) for x in (a, b)]
        ((ps[0] * 3.0).sum() + (ps[1] ** 2).sum()).backward()
        total = pkg.optimizer.clip_grad_norm_(ps, 1.5, norm_type)
        out.append([float(total)] + [p.grad.numpy() for p in ps])
    for x, y in zip(*out):
        np.testing.assert_allclose(y, x, rtol=1e-6)


def test_train_step_and_scaler_take_sparse_gradients(cpu):
    """``jit.TrainStep`` takes a sparse embedding's gradient dense (as
    paddle_tpu's compiled step does); ``GradScaler`` unscales a sparse
    gradient: both give what the dense embedding gives."""
    pt = paddle_tpu_torch
    ids = pt.to_tensor(IDS)
    res = []
    for sparse in (True, False):
        _, te = _embeddings(sparse=sparse)
        opt = pt.optimizer.Adam(0.1, parameters=te.parameters(),
                                lazy_mode=True)
        step = pt.jit.TrainStep(te, lambda out, y: (out * y).sum(), opt)
        loss = step(ids, pt.to_tensor(np.ones((2, 3, D), np.float32)))
        _, te2 = _embeddings(sparse=sparse)
        opt2 = pt.optimizer.SGD(0.1, parameters=te2.parameters())
        scaler = pt.amp.GradScaler(init_loss_scaling=1024.0)
        scaler.scale(te2(ids).sum()).backward()
        scaler.step(opt2)
        scaler.update()
        res.append((float(loss), te.weight.numpy(), te2.weight.numpy()))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-6)
    np.testing.assert_allclose(res[0][1], res[1][1], rtol=1e-6)
    np.testing.assert_allclose(res[0][2], res[1][2], rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", ["sgd", "adam_lazy"])
def test_cuda_sparse_updates_match_the_cpu(opt_name):
    """Sparse SGD and lazy Adam on the card against the CPU: untouched
    rows bitwise unchanged on the card, the rest within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = np.random.RandomState(1).randn(V, D).astype("float32")
    out = []
    for dev in ("cpu", "cuda"):
        emb = paddle_tpu_torch.nn.Embedding(V, D, sparse=True, device=dev)
        emb.weight.set_value(w)
        opt = OPTS[opt_name](paddle_tpu_torch.optimizer, emb.parameters())
        for _ in range(3):
            ids = paddle_tpu_torch.to_tensor(IDS, place=dev)
            (emb(ids) ** 2).sum().backward()
            opt.step()
            opt.clear_grad()
        out.append(emb.weight.numpy())
    untouched = np.setdiff1d(np.arange(V), IDS)
    np.testing.assert_array_equal(out[1][untouched], w[untouched])
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=1e-6)
