"""The spec's class members on the port, held to paddle_tpu on the CPU.

- ``DataParallel`` is an ``nn.Layer`` (fault C21): its members, its
  sublayers, ``paddle.summary``, ``paddle.Model`` and fleet's wrapper,
  with its state dict and collective answers as they were.
- The static ``Variable``'s Tensor members (fault C22): ``clone``
  records a node the Executor runs; the other fourteen give
  paddle_tpu's answers and record nothing.
- ``jit.TrainStep.sync_params`` (fault C23), the base steps' no-op.
- ``update_param`` of the ``Optimizer`` base and its 15 subclasses:
  six steps at the ragged shapes of ``tests/test_pallas.py:298``,
  within 1e-6 of paddle_tpu's (Dpsgd on paddle_tpu's draws).
- ``StaticFunction.concrete``: the pure function on a small BERT
  (bench.py:167 widths, dropout 0), eval and train, within 1e-5, and on
  a small conv net with batch norm, whose buffers come back updated.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"paddle_tpu": J, "port": T}


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    T.set_device("cpu")
    yield
    placement.set_default(prev)
    J.disable_static()
    T.disable_static()


def _mlp(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))


def _numpy(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


# -- C21: DataParallel is a Layer --------------------------------------------
def _dp_answers(pkg):
    pkg.seed(3)
    net = _mlp(pkg)
    dp = pkg.DataParallel(net)
    x = pkg.to_tensor(np.ones((1, 4), np.float32), stop_gradient=False)
    dp(x).sum().backward()
    had_grads = all(p.grad is not None for p in dp.parameters())
    cleared = dp.clear_gradients()
    sd = {k: _numpy(v) for k, v in dp.state_dict().items()}
    ones = {k: np.ones_like(v) for k, v in sd.items()}
    return {
        "is_layer": isinstance(dp, pkg.nn.Layer),
        "sublayers": [type(m).__name__ for m in dp.sublayers()],
        "named_sublayers": [n for n, _ in dp.named_sublayers()],
        "full_name": dp.full_name(),
        "grads_then_cleared": (had_grads, cleared,
                               [p.grad for p in dp.parameters()]),
        "parameters": len(dp.parameters()),
        "summary": pkg.summary(dp, (1, 4)),
        "model_parameters": (type(pkg.Model(dp).parameters()).__name__,
                             len(pkg.Model(dp).parameters())),
        "state_dict_keys": sorted(sd),
        "load_dict": (dp.load_dict(ones),
                      float(_numpy(net[0].weight).sum())),
        "astype_is_self": dp.astype("float32") is dp,
    }


def test_data_parallel_is_a_layer_as_in_paddle_tpu():
    """C21: at world size 1 the wrapper answers paddle_tpu's: a Layer of
    4 sublayers named ``_layers*``, ``'dataparallel'``, 58 parameters in
    the summary, a list of 4 from ``Model.parameters()``, the wrapped
    layer's state-dict keys, and ``load_dict`` loading into it."""
    want, got = _dp_answers(J), _dp_answers(T)
    assert want["is_layer"] and got["is_layer"]
    assert want["summary"] == {"total_params": 58, "trainable_params": 58}
    assert want["grads_then_cleared"] == (True, None, [None] * 4)
    assert got == want


def test_data_parallel_layer_members_as_in_paddle_tpu():
    """The spec's other members: ``create_parameter``, ``add_parameter``,
    ``add_sublayer`` and ``register_forward_post_hook`` (its handle takes
    the hook off)."""
    out = {}
    for side, pkg in SIDES.items():
        dp = pkg.DataParallel(_mlp(pkg))
        p = dp.create_parameter([3])
        added = dp.add_parameter("extra", p) is p
        n_params = len(dp.parameters())
        sub = dp.add_sublayer("extra_l", pkg.nn.Linear(2, 2))
        x = pkg.to_tensor(np.ones((1, 4), np.float32))
        base = _numpy(dp(x)).copy()
        h = dp.register_forward_post_hook(lambda layer, i, o: o * 2)
        hooked = _numpy(dp(x))
        h.remove()
        out[side] = (list(p.shape), added, n_params, type(sub).__name__,
                     len(dp.sublayers()), np.allclose(hooked, 2 * base),
                     np.allclose(_numpy(dp(x)), base))
    assert out["port"] == out["paddle_tpu"] == (
        [3], True, 5, "Linear", 5, True, True)


def test_data_parallel_keeps_its_state_dict_and_collective_answers():
    """The wrapped layer's parameters once (not doubled by the sublayer),
    state-dict keys without a ``_layers.`` prefix, ``set_state_dict``
    into the wrapped layer, ``scale_loss`` the identity,
    ``apply_collective_grads`` None, and fleet's ``distributed_model``
    wrapping the same model (the shell its save unwraps)."""
    from paddle_tpu_torch.distributed.fleet import Fleet
    net = _mlp(T)
    dp = Fleet().distributed_model(net)
    assert isinstance(dp, T.DataParallel) and dp._layers is net
    assert getattr(dp, "_layers", dp) is net
    assert [id(p) for p in dp.parameters()] == \
        [id(p) for p in net.parameters()]
    assert list(dp.state_dict()) == list(net.state_dict())
    zeros = {k: torch.zeros_like(v) for k, v in net.state_dict().items()}
    assert dp.set_state_dict(zeros) == ([], [])
    assert all(float(p.abs().sum()) == 0.0 for p in net.parameters())
    x = T.to_tensor(np.ones((2, 4), np.float32))
    assert torch.equal(dp(x), net(x))
    loss = dp(x).sum()
    assert dp.scale_loss(loss) is loss
    assert dp.apply_collective_grads() is None


# -- C22: the static Variable's Tensor members -------------------------------
MEMBERS = ["numpy", "item", "tolist", "detach", "cpu", "backward", "cuda",
           "pin_memory", "set_value", "fill_", "zero_", "clear_grad",
           "clear_gradient", "register_hook"]


def _call(x, member):
    if member == "set_value":
        return x.set_value(np.ones((2, 3), np.float32))
    if member == "fill_":
        return x.fill_(3.0)
    if member == "register_hook":
        return x.register_hook(lambda g: g)
    return getattr(x, member)()


def _variable_answer(pkg, member):
    """What ``member`` gives on a [2, 3] f32 Variable, and the nodes it
    recorded: ('self',), ('none',), ('raises', TypeError-or-other),
    ('abstract', shape), ('handle', removable)."""
    pkg.enable_static()
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        x = pkg.static.data("x", [2, 3], "float32")
        try:
            r = _call(x, member)
        except Exception as e:      # noqa: BLE001 - the answer under test
            ans = ("raises", type(e).__name__ if isinstance(
                e, (RuntimeError, TypeError)) else "other")
        else:
            if r is x:
                ans = ("self",)
            elif r is None:
                ans = ("none",)
            elif hasattr(r, "remove"):
                r.remove()
                ans = ("handle",)
            else:
                val = r[()] if isinstance(r, np.ndarray) else r
                ans = ("abstract", type(r).__name__ == "ndarray",
                       tuple(val.shape))
        nodes = len(main.nodes)
    pkg.disable_static()
    return ans, nodes


@pytest.mark.parametrize("member", MEMBERS)
def test_static_variable_member_answers_as_paddle_tpus(member):
    """C22: each member gives paddle_tpu's kind of answer and records no
    op.  ``numpy`` is a 0-d object array of the abstract value (the
    port's ``meta``), ``item``/``tolist`` the abstract value; ``detach``
    and ``cpu`` refuse (TypeError naming the member on the port; a jax
    error for ``cpu`` on paddle_tpu); ``backward`` on a non-scalar is a
    RuntimeError."""
    want, got = _variable_answer(J, member), _variable_answer(T, member)
    if member == "cpu":
        assert want == (("raises", "other"), 0)
        assert got == (("raises", "TypeError"), 0)
        T.enable_static()
        with T.static.program_guard(T.static.Program()):
            with pytest.raises(TypeError, match="Variable.cpu"):
                T.static.data("x", [2], "float32").cpu()
        return
    assert got == want
    assert want[1] == 0


def test_static_variable_clone_records_a_clone_op():
    """C22: ``x.clone() * 2`` records ``clone`` and ``multiply``; the
    Executor gives 2s on ones, as in paddle_tpu.  A scalar's
    ``backward`` records nothing and returns None."""
    out = {}
    for side, pkg in SIDES.items():
        pkg.enable_static()
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            x = pkg.static.data("x", [2, 3], "float32")
            s = pkg.static.data("s", [], "float32")
            assert s.backward() is None
            y = x.clone() * 2
        names = [n.op_name for n in main.nodes]
        res = pkg.static.Executor().run(
            main, feed={"x": np.ones((2, 3), np.float32),
                        "s": np.float32(1.0)}, fetch_list=[y])
        pkg.disable_static()
        out[side] = (names, np.asarray(res[0]))
    assert out["port"][0] == out["paddle_tpu"][0] == ["clone", "multiply"]
    np.testing.assert_array_equal(out["port"][1], out["paddle_tpu"][1])
    np.testing.assert_array_equal(out["port"][1], np.full((2, 3), 2.0))


def test_static_variable_set_value_checks_the_shape():
    for pkg in SIDES.values():
        pkg.enable_static()
        with pkg.static.program_guard(pkg.static.Program()):
            x = pkg.static.data("x", [2, 3], "float32")
            with pytest.raises(ValueError, match="shape mismatch"):
                x.set_value(np.ones((3, 2), np.float32))
        pkg.disable_static()


# -- C23: TrainStep.sync_params ----------------------------------------------
def test_train_step_sync_params_is_the_base_no_op():
    """C23: after a step of ``TrainStep(Linear(4, 2), mse, SGD)``,
    ``sync_params()`` returns None and changes nothing, on both."""
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(8, 2).astype(np.float32)
    out = {}
    for side, pkg in SIDES.items():
        pkg.seed(5)
        net = pkg.nn.Linear(4, 2)
        step = pkg.jit.TrainStep(
            net, lambda o, l, F=pkg.nn.functional: F.mse_loss(o, l),
            pkg.optimizer.SGD(0.1, parameters=net.parameters()))
        step(pkg.to_tensor(x), pkg.to_tensor(y))
        before = {k: _numpy(v).copy() for k, v in net.state_dict().items()}
        r = step.sync_params()
        after = {k: _numpy(v) for k, v in net.state_dict().items()}
        assert r is None
        for k in before:
            np.testing.assert_array_equal(before[k], after[k])
        out[side] = r
    assert out["port"] is out["paddle_tpu"] is None


# -- update_param -----------------------------------------------------------
OPTIMIZERS = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
              "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "Ftrl",
              "Dpsgd", "ProximalGD", "ProximalAdagrad", "DecayedAdagrad"]
OPT_KW = {"ProximalGD": dict(l1=0.01, l2=0.01),
          "ProximalAdagrad": dict(l1=0.01, l2=0.01),
          "RMSProp": dict(centered=True, momentum=0.5),
          "Momentum": dict(use_nesterov=True)}
LR = 1e-3


def _dpsgd_draw(jo, step, noise_id):
    key = jax.random.fold_in(jax.random.PRNGKey(jo._seed),
                             jnp.asarray(step, jnp.int32))
    key = jax.random.fold_in(key, noise_id)
    return float(jax.random.normal(key, (), jnp.float32))


@pytest.mark.parametrize("shape", [(7,), (130, 33)], ids=["7", "130x33"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_update_param_matches_paddle_tpus(name, shape):
    """Six steps of ``update_param(p, g, slots, lr, step)`` from the same
    numpy parameter and gradients: the parameter within 1e-6 and every
    slot paddle_tpu keeps within 1e-6 absolute plus 1e-6 relative.
    ``lr``/``step`` alternate between Python numbers and 0-d tensors;
    ``p``, ``g`` and ``slots`` are left as they were."""
    r = np.random.RandomState(OPTIMIZERS.index(name))
    kw = dict(learning_rate=LR, **OPT_KW.get(name, {}))
    jo, to = getattr(J.optimizer, name)(**kw), getattr(T.optimizer, name)(
        **kw)
    p0 = r.randn(*shape).astype(np.float32)
    jp, tp = jnp.asarray(p0), torch.from_numpy(p0.copy())
    js, ts = jo.init_slots(jp), to.init_slots(tp)
    for step in range(1, 7):
        g = r.randn(*shape).astype(np.float32)
        if name == "Dpsgd":
            n = _dpsgd_draw(jo, step, js["noise_id"])
            to._draw = lambda st, k, dev, n=n: torch.full((k,), n)
        jp, js = jo.update_param(jp, jnp.asarray(g), js,
                                 jnp.asarray(LR, jnp.float32),
                                 jnp.asarray(step, jnp.float32))
        as_tensor = step % 2 == 0
        gt = torch.from_numpy(g)
        kept = (tp.clone(), {k: v.clone() for k, v in ts.items()})
        tp2, ts2 = to.update_param(
            tp, gt, ts, torch.tensor(LR) if as_tensor else LR,
            torch.tensor(float(step)) if as_tensor else step)
        assert torch.equal(gt, torch.from_numpy(g))
        assert torch.equal(tp, kept[0])
        assert all(torch.equal(ts[k], v) for k, v in kept[1].items())
        tp, ts = tp2, ts2
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)
    # slots that sum squares grow to ~10, where 1e-6 is one f32 ulp: held
    # relative (torch's addcmul rounds once where jnp rounds twice)
    for k in js:
        if k != "noise_id":
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_optimizer_base_update_param_raises_as_in_paddle_tpu():
    for pkg in SIDES.values():
        with pytest.raises(NotImplementedError):
            pkg.optimizer.Optimizer(0.1).update_param(
                pkg.to_tensor(np.ones(3, np.float32)),
                pkg.to_tensor(np.ones(3, np.float32)), {}, 0.1, 1)


# -- StaticFunction.concrete --------------------------------------------------
def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bert_pair():
    """bench_bert's CPU widths at dropout 0 on both packages, the port's
    from paddle_tpu's weights, each's forward under ``to_static``."""
    from paddle_tpu_torch.testing.models import build_model
    c = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512, seq=128)
    J.seed(11)
    jm = _bench().build_model(c["vocab"], c["hidden"], c["layers"],
                              c["heads"], c["ffn"], c["seq"], 0.0)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = build_model(c["vocab"], c["hidden"], c["layers"], c["heads"],
                     c["ffn"], c["seq"], 0.0, device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(state, "cpu", model=tm))
    J.jit.to_static(jm)
    T.jit.to_static(tm)
    ids = np.random.RandomState(0).randint(0, c["vocab"], (2, c["seq"]),
                                           dtype=np.int32)
    return jm, tm, ids


def _jax_concrete(layer, *args):
    from paddle_tpu.jit.bind import buffer_arrays, param_list
    pure, targs = layer.forward.concrete(*args)
    key = jax.random.key_data(jax.random.PRNGKey(0))
    out, new_b = pure(key, *[p.data for p in param_list(layer)],
                      *buffer_arrays(layer), *[a.data for a in targs])
    return out, new_b, len(targs)


def _port_concrete(layer, *args):
    pure, targs = layer.forward.concrete(*args)
    params = [p.detach() for p in layer.parameters()]
    buffers = [b.detach().clone() for b in layer.buffers()]
    out, new_b = pure(0, *params, *buffers, *targs)
    for b, kept in zip(layer.buffers(), buffers):
        assert torch.equal(b, kept)           # the layer's are not written
    return out, new_b, len(targs)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_concrete_pure_function_matches_paddle_tpus(bert_pair, train):
    """``concrete(ids)`` -> ``(pure_fn, [ids])``; ``pure_fn(key,
    *params, *buffers, ids)`` -> ``(outputs, new_buffers)``, the outputs
    within 1e-5 of paddle_tpu's pure function's."""
    jm, tm, ids = bert_pair
    for m in (jm, tm):
        m.train() if train else m.eval()
    jout, jb, jn = _jax_concrete(jm, J.to_tensor(ids))
    tout, tb, tn = _port_concrete(tm, torch.from_numpy(ids))
    assert jn == tn == 1 and len(jb) == len(tb) == 0
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    tout2, _, _ = _port_concrete(tm, torch.from_numpy(ids))
    assert torch.equal(tout, tout2)


def test_concrete_batch_norm_buffers_match_paddle_tpus():
    """A conv + batch norm net in training mode: the outputs and the
    updated running statistics within 1e-5 of paddle_tpu's, the
    layer's own buffers untouched."""
    nets = {}
    for side, pkg in SIDES.items():
        pkg.seed(12)
        nn = pkg.nn
        nets[side] = nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4),
                                   nn.ReLU())
    state = {k: np.asarray(v.numpy())
             for k, v in nets["paddle_tpu"].state_dict().items()}
    nets["port"].load_state_dict(state_dict_from_paddle_tpu(
        state, "cpu", model=nets["port"]))
    x = np.random.RandomState(2).randn(2, 3, 8, 8).astype(np.float32)
    for net in nets.values():
        net.train()
    J.jit.to_static(nets["paddle_tpu"])
    T.jit.to_static(nets["port"])
    jout, jb, _ = _jax_concrete(nets["paddle_tpu"], J.to_tensor(x))
    tout, tb, _ = _port_concrete(nets["port"], torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    assert len(jb) == len(tb) == 2
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    assert not torch.equal(tb[0], torch.zeros(4))
