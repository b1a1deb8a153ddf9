"""The custom-op path on the port (``utils.custom_op``,
``utils.cpp_extension``, ``utils.op_version``), held to paddle_tpu on the
CPU.

- ``register_custom_op``: the twins of
  ``tests/test_utils_extras.py::test_custom_op_forward_and_autodiff`` and
  ``::test_custom_op_custom_vjp`` on both packages; the op under
  ``amp.auto_cast`` (cast by its name at the dispatch point), with a
  profiler and a tracer ``op`` event under its name, and recorded as one
  node of a static ``Program`` that the Executor runs to the eager value.
- ``cpp_extension.load``: the five cases of ``tests/test_cpp_extension.py``
  (:74-154), each with its leaky-relu C++ source written against torch's
  operator registration (``torch/library.h``) instead of the XLA FFI
  (``paddle_tpu_torch/testing/csrc/leaky_relu_ext.cpp``, which
  ``chip_smoke.py`` builds on the card too).
  The module builds the library once (one ``g++`` run against torch's
  headers); "under jit and vmap" is under ``jit.to_static`` and
  ``torch.func.vmap`` here.
- ``op_version`` on both packages, and ``nn.functional.extension``.

The card's cases are in ``tests/test_torch_custom_op_cuda.py``.
"""
import functools
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.core import placement

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain")

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "paddle_tpu_torch", "testing", "csrc", "leaky_relu_ext.cpp")


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    T.set_device("cpu")
    yield
    placement.set_default(prev)
    T.disable_static()


@pytest.fixture(scope="module")
def ext(tmp_path_factory):
    from paddle_tpu_torch.utils.cpp_extension import load
    root = tmp_path_factory.mktemp("ext")
    src = root / "leaky.cpp"
    shutil.copyfile(SRC, src)
    return load(
        "leaky_ext", [str(src)],
        functions={
            "leaky_fwd": {"symbol": "LeakyReluFwd", "out": "like:0"},
            "leaky_bwd": {"symbol": "LeakyReluBwd", "out": "like:0"},
        },
        build_directory=str(root / "build"))


# -- register_custom_op -------------------------------------------------------
def test_custom_op_forward_and_autodiff():
    """``relu_cubed``: forward [0, 8], autodiff's gradient 3x^2 [0, 12],
    on both packages."""
    import jax.numpy as jnp
    out = {}
    for pkg, fn in ((J, lambda a: jnp.maximum(a, 0) ** 3),
                    (T, lambda a: torch.clamp(a, min=0) ** 3)):
        relu3 = pkg.utils.register_custom_op("relu_cubed", fn)
        x = pkg.to_tensor(np.array([-1.0, 2.0], np.float32),
                          stop_gradient=False)
        y = relu3(x)
        y.sum().backward()
        out[pkg.__name__] = (y.numpy(), x.grad.numpy())
    for y, g in out.values():
        np.testing.assert_allclose(y, [0.0, 8.0])
        np.testing.assert_allclose(g, [0.0, 12.0])


def test_custom_op_custom_vjp():
    """A straight-through sign: forward sign(x), the given backward
    passes the gradient through."""
    import jax.numpy as jnp
    out = {}
    for pkg, fn in ((J, jnp.sign), (T, torch.sign)):
        st_sign = pkg.utils.register_custom_op(
            "st_sign", fn, backward=lambda res, ct: (ct,))
        x = pkg.to_tensor(np.array([-2.0, 3.0], np.float32),
                          stop_gradient=False)
        y = st_sign(x)
        y.sum().backward()
        out[pkg.__name__] = (y.numpy(), x.grad.numpy())
    for y, g in out.values():
        np.testing.assert_allclose(y, [-1.0, 1.0])
        np.testing.assert_allclose(g, [1.0, 1.0])


def test_custom_backward_gets_the_inputs_and_attrs():
    """``res`` is the tuple of the forward's inputs (a literal input
    gets no gradient); ``get_custom_op`` finds the latest registration
    of a name, as paddle_tpu's registry does."""
    from paddle_tpu_torch.utils.custom_op import get_custom_op
    seen = []

    def fwd(a, b, scale, *, shift):
        return a * b * scale + shift

    def bwd(res, ct):
        seen.append(res)
        a, b, scale = res
        return ct * b * scale, ct * a * scale, None

    op = T.utils.register_custom_op("scaled_mul", fwd, backward=bwd)
    a = T.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
    b = T.to_tensor(np.array([3.0, 4.0], np.float32), stop_gradient=False)
    y = op(a, b, 2.0, shift=1.0)
    np.testing.assert_allclose(y.numpy(), [7.0, 17.0])
    y.sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), [6.0, 8.0])
    np.testing.assert_allclose(b.grad.numpy(), [2.0, 4.0])
    assert seen[0][2] == 2.0 and torch.equal(seen[0][0], a)
    assert get_custom_op("scaled_mul") is op
    again = T.utils.register_custom_op("scaled_mul", lambda a, b: a - b)
    assert get_custom_op("scaled_mul") is again
    J.utils.register_custom_op("scaled_mul", lambda a, b: a + b)
    from paddle_tpu.utils.custom_op import get_custom_op as jget
    assert jget("scaled_mul").__name__ == get_custom_op(
        "scaled_mul").__name__ == "scaled_mul"


@pytest.mark.parametrize("level,white", [("O1", False), ("O1", True),
                                         ("O2", False)])
def test_custom_op_is_cast_by_its_name_under_auto_cast(level, white):
    """The inputs are cast at the dispatch point by the op's name, before
    the function sees them: untouched at O1 unless white-listed, bf16 at
    O2, on both packages."""
    seen = {}
    for pkg in (J, T):
        def fwd(a, pkg=pkg):
            seen[pkg.__name__] = str(a.dtype).replace("torch.", "")
            return a * 2
        op = pkg.utils.register_custom_op("amp_probe", fwd)
        x = pkg.to_tensor(np.ones(4, np.float32))
        with pkg.amp.auto_cast(level=level, dtype="bfloat16",
                               custom_white_list=["amp_probe"] if white
                               else None):
            op(x)
    assert seen["paddle_tpu"] == seen["paddle_tpu_torch"] == (
        "bfloat16" if white or level == "O2" else "float32")


def test_custom_op_emits_profiler_and_tracer_events():
    """One call is one ``op`` event under the op's name for the tracer
    and one row of the profiler's op table, on both packages."""
    got = {}
    for pkg in (J, T):
        op = pkg.utils.register_custom_op("events_probe", lambda a: a + 1)
        x = pkg.to_tensor(np.ones(3, np.float32))
        t = pkg.observability.enable(capacity=256)
        with pkg.profiler.Profiler(timer_only=True) as prof:
            op(x)
            op(x)
        pkg.observability.disable()
        ops = [e["name"] for e in t.events() if e["kind"] == "op"]
        rows = {n: c for n, c, _ in prof.key_averages()}
        got[pkg.__name__] = (ops.count("events_probe"),
                             rows.get("events_probe"))
    assert got["paddle_tpu"] == got["paddle_tpu_torch"] == (2, 2)


def test_custom_op_records_one_node_in_a_static_program():
    """Inside a ``Program`` the op records one node under its name; the
    Executor's value equals the eager op's, on both packages."""
    import jax.numpy as jnp
    xv = np.array([[-1.0, 2.0], [3.0, -4.0]], np.float32)
    got = {}
    for pkg, fn in ((J, lambda a: jnp.maximum(a, 0) ** 3),
                    (T, lambda a: torch.clamp(a, min=0) ** 3)):
        op = pkg.utils.register_custom_op("relu_cubed_static", fn)
        eager = op(pkg.to_tensor(xv)).numpy()
        pkg.enable_static()
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            v = pkg.static.data("v", [2, 2], "float32")
            out = op(v)
        names = [n.op_name for n in main.nodes]
        res = pkg.static.Executor().run(main, feed={"v": xv},
                                        fetch_list=[out])
        pkg.disable_static()
        np.testing.assert_array_equal(np.asarray(res[0]), eager)
        got[pkg.__name__] = (names, np.asarray(res[0]))
    assert got["paddle_tpu"][0] == got["paddle_tpu_torch"][0] == [
        "relu_cubed_static"]
    np.testing.assert_array_equal(got["paddle_tpu"][1],
                                  got["paddle_tpu_torch"][1])


def test_custom_op_inside_a_recomputed_train_step():
    """A custom op with a backward pair in the loss of a ``TrainStep``
    with ``recompute=True`` trains as without recompute."""
    losses = []
    for recompute in (False, True):
        T.seed(9)
        net = T.nn.Linear(4, 4)
        op = T.utils.register_custom_op(
            "sq", lambda a: a * a, backward=lambda res, ct: (2 * res[0] * ct,))
        step = T.jit.TrainStep(net, lambda o, y: (op(o) - y).mean(),
                               T.optimizer.SGD(0.1,
                                               parameters=net.parameters()),
                               recompute=recompute)
        x = T.to_tensor(np.random.RandomState(0).randn(8, 4).astype(
            np.float32))
        losses.append([float(step(x, x)) for _ in range(3)])
    assert losses[0] == losses[1]


# -- cpp_extension ----------------------------------------------------------
@needs_gxx
def test_extension_forward_numerics(ext):
    x = np.array([-2.0, -0.5, 0.0, 1.5], np.float32)
    y = ext.leaky_fwd(x, alpha=np.float32(0.1)).numpy()
    np.testing.assert_allclose(y, np.where(x > 0, x, 0.1 * x), rtol=1e-6)


@needs_gxx
def test_extension_under_to_static_and_vmap(ext):
    f = T.jit.to_static(functools.partial(ext.leaky_fwd, alpha=0.2))
    x = torch.from_numpy(np.linspace(-2, 2, 16, dtype=np.float32))
    np.testing.assert_allclose(f(x).numpy(),
                               np.where(x > 0, x, 0.2 * x.numpy()),
                               rtol=1e-6)
    xb = torch.stack([x, -x])
    vb = torch.func.vmap(lambda a: ext.leaky_fwd(a, alpha=0.2))(xb)
    assert tuple(vb.shape) == (2, 16)
    np.testing.assert_allclose(vb.numpy(),
                               np.where(xb > 0, xb, 0.2 * xb.numpy()),
                               rtol=1e-6)
    vt = torch.func.vmap(lambda a: ext.leaky_fwd(a, alpha=0.2),
                         in_dims=1)(xb)
    np.testing.assert_allclose(vt.numpy(), vb.numpy().T, rtol=1e-6)


@needs_gxx
def test_register_custom_op_with_native_backward(ext):
    """The native forward and backward wired through
    ``register_custom_op``'s pair, driven by the eager tape; the op also
    records into a static Program (its ``out`` spec is its Meta
    kernel)."""
    alpha = 0.1
    fwd = functools.partial(ext.leaky_fwd, alpha=alpha)

    def bwd(res, ct):
        (x,) = res
        return (ext.leaky_bwd(x, ct, alpha=alpha),)

    op = T.utils.register_custom_op("native_leaky_relu", fwd, backward=bwd)
    xv = np.array([-3.0, -1.0, 2.0, 4.0], np.float32)
    x = T.to_tensor(xv, stop_gradient=False)
    y = op(x)
    np.testing.assert_allclose(y.numpy(), np.where(xv > 0, xv, 0.1 * xv),
                               rtol=1e-6)
    (y * T.to_tensor(np.array([1.0, 2.0, 3.0, 4.0], np.float32))
     ).sum().backward()
    expect = np.where(xv > 0, 1.0, 0.1) * np.array([1, 2, 3, 4],
                                                   np.float32)
    np.testing.assert_allclose(x.grad.numpy(), expect, rtol=1e-6)
    T.enable_static()
    main = T.static.Program()
    with T.static.program_guard(main):
        v = T.static.data("v", [4], "float32")
        out = op(v)
    res = T.static.Executor().run(main, feed={"v": xv}, fetch_list=[out])
    T.disable_static()
    assert [n.op_name for n in main.nodes] == ["native_leaky_relu"]
    np.testing.assert_allclose(np.asarray(res[0]), y.numpy(), rtol=0)


@needs_gxx
def test_rebuild_only_when_stale(ext):
    """The same sources and flags in the same directory load the cached
    library; a callable ``out`` spec gives the output's shape and
    dtype.  Another flag builds another library."""
    from paddle_tpu_torch.utils.cpp_extension import load
    so = ext.__so_path__
    mtime = os.path.getmtime(so)
    src_dir = os.path.dirname(so)
    src = os.path.join(os.path.dirname(src_dir), "leaky.cpp")
    mod = load("leaky_ext", [src],
               functions={"leaky_fwd": {
                   "symbol": "LeakyReluFwd",
                   "out": lambda a: (a.shape, a.dtype)}},
               build_directory=src_dir)
    assert mod.__so_path__ == so and os.path.getmtime(so) == mtime
    x = np.array([-1.0, 1.0], np.float32)
    np.testing.assert_allclose(mod.leaky_fwd(x, alpha=0.5).numpy(),
                               [-0.5, 1.0], rtol=1e-6)
    meta = mod.leaky_fwd(torch.empty(5, device="meta"), alpha=0.5)
    assert meta.shape == (5,) and meta.dtype == torch.float32


@needs_gxx
def test_load_errors_are_loud(tmp_path, monkeypatch):
    from paddle_tpu_torch.utils.cpp_extension import (CppExtension,
                                                      get_build_directory,
                                                      load)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++")
    with pytest.raises(RuntimeError, match="compiler failed"):
        load("badext", [str(bad)], functions={},
             build_directory=str(tmp_path / "b"))
    with pytest.raises(FileNotFoundError):
        load("missing", [str(tmp_path / "nope.cpp")], functions={})
    with pytest.raises(NotImplementedError, match="cpp_extension.load"):
        CppExtension("x")
    monkeypatch.setenv("PADDLE_TPU_EXTENSION_DIR", str(tmp_path / "env"))
    assert get_build_directory() == str(tmp_path / "env")
    assert os.path.isdir(tmp_path / "env")


# -- op_version and the functional alias ------------------------------------
def test_op_version_registry_as_in_paddle_tpu():
    got = {}
    for pkg in (J, T):
        ov = pkg.utils.op_version
        assert ov.get_op_version("never_registered_op") == 0
        first = ov.register_op_version("probe_op_v", 1, "added")
        second = ov.register_op_version("probe_op_v", 2, "new attr")
        ov.register_op_version("probe_op_v", 2)
        got[pkg.__name__] = (tuple(first), tuple(second),
                             tuple(ov._registry["probe_op_v"]),
                             ov.get_op_version("probe_op_v"),
                             ov.all_op_versions()["probe_op_v"])
    assert got["paddle_tpu"] == got["paddle_tpu_torch"] == (
        (1, ["added"]), (2, ["added", "new attr"]),
        (2, ["added", "new attr"]), 2, 2)


def test_functional_extension_is_the_parent_namespace():
    from paddle_tpu_torch.nn.functional import extension
    assert extension.gelu is T.nn.functional.gelu
    assert extension.scaled_dot_product_attention is \
        T.nn.functional.scaled_dot_product_attention
