"""The rest of the eager surface on the port, held to paddle_tpu on the
CPU: the flags registry, ``framework_compat``'s names (``*Place``, the
dygraph switches, the CUDA RNG state, ``create_parameter``, ``flops``,
``set_printoptions``), the device queries, the public
``paged_attention`` with its registration rule, ``ops``' and the top
level's helper names, ``core.profiler_hook``, the entries of
``ops.pallas`` on CPU tensors against paddle_tpu's in interpret mode,
and fault C8 (a Python ``if`` on a static Variable names
``static.nn.cond``)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.ops.pallas as jpallas
import paddle_tpu_torch as T
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
from paddle_tpu_torch.ops import pallas as tpallas
from paddle_tpu_torch.ops.cuda import support


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    T.set_device("cpu")
    yield
    placement.set_default(prev)


# -- flags ------------------------------------------------------------------
def test_flags_have_paddle_tpus_names_and_defaults():
    want = {n: d.default for n, d in jflags._registry.items()}
    got = {n: d.default for n, d in tflags._registry.items()}
    assert len(want) == 47 and got == want
    assert set(T.get_flags()) == set(J.get_flags())


def test_set_flags_round_trips_and_names_unknown_flags():
    before = T.get_flags(["FLAGS_check_nan_inf", "perf_sample_every"])
    assert before == {"check_nan_inf": False, "perf_sample_every": 16}
    try:
        T.set_flags({"FLAGS_perf_sample_every": 4, "check_nan_inf": True})
        assert T.get_flags("perf_sample_every") == {"perf_sample_every": 4}
        assert tflags.get_flag("check_nan_inf") is True
    finally:
        T.set_flags(before)
    assert T.get_flags(list(before)) == before
    with pytest.raises(KeyError, match="no_such_flag"):
        T.set_flags({"no_such_flag": 1})


@pytest.mark.parametrize("name", sorted(tflags.CARD_LESS))
def test_xla_and_tpu_flags_take_only_their_default(name):
    default = tflags._registry[name].default
    T.set_flags({name: default})
    other = ("x" if isinstance(default, str) else
             (not default) if isinstance(default, bool) else default + 1)
    with pytest.raises(ValueError, match=name):
        T.set_flags({f"FLAGS_{name}": other})
    assert tflags.get_flag(name) == default


# -- framework_compat ---------------------------------------------------------
def test_places_compare_by_type_and_ordinal():
    assert T.CUDAPlace(0) == T.CUDAPlace(0) != T.CUDAPlace(1)
    assert T.CPUPlace() != T.CUDAPinnedPlace()
    assert repr(T.XPUPlace(2)) == "XPUPlace(2)" == repr(J.XPUPlace(2))
    assert len({T.CUDAPlace(0), T.CUDAPlace(0), T.TPUPlace(0)}) == 2


def test_dygraph_switches():
    for pkg in (J, T):
        assert pkg.in_dygraph_mode()
        pkg.disable_dygraph()
        try:
            assert not pkg.in_dygraph_mode()
        finally:
            pkg.enable_dygraph()
        assert pkg.in_dygraph_mode()


def test_cuda_rng_state_replays_dropout_and_flash_seeds():
    T.seed(11)
    x = T.to_tensor(np.ones((8, 64), np.float32))
    T.nn.functional.dropout(x, 0.5)
    state = T.get_cuda_rng_state()
    first = (T.nn.functional.dropout(x, 0.5).numpy(), T.next_key())
    T.nn.functional.dropout(x, 0.5)
    T.set_cuda_rng_state(state)
    again = (T.nn.functional.dropout(x, 0.5).numpy(), T.next_key())
    np.testing.assert_array_equal(again[0], first[0])
    assert again[1] == first[1]
    T.set_cuda_rng_state(state)          # a state is put back again
    np.testing.assert_array_equal(T.nn.functional.dropout(x, 0.5).numpy(),
                                  first[0])


def test_device_answers_on_this_build():
    """Without a CUDA build (this box's torch) the card-dependent answers
    are the JAX package's, but ``device_count``, which counts CUDA
    devices (paddle_tpu counts its CPU device); on the card all three
    differ from paddle_tpu's (ROADMAP section C)."""
    assert T.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert T.get_cudnn_version() == torch.backends.cudnn.version()
    assert T.device_count() == (torch.cuda.device_count()
                                if torch.cuda.is_available() else 0)
    assert T.device.get_all_devices() == [
        f"gpu:{i}" for i in range(T.device_count())]
    assert not T.is_compiled_with_tpu() and not T.is_compiled_with_xpu()
    if not torch.backends.cuda.is_built():
        assert T.is_compiled_with_cuda() is J.is_compiled_with_cuda()
        assert T.get_cudnn_version() is J.get_cudnn_version() is None
        assert T.device_count() == 0 and J.device_count() >= 1


def test_set_printoptions_reaches_a_tensors_repr():
    a = np.arange(10, dtype=np.float32)
    before = np.get_printoptions()
    try:
        for pkg in (J, T):
            pkg.set_printoptions(threshold=5, edgeitems=1)
        got, want = repr(T.to_tensor(a)), repr(J.to_tensor(a))
    finally:
        np.set_printoptions(**before)
    assert "..." in got and got.split("\n")[-1] == want.split("\n")[-1]
    assert "..." not in repr(T.to_tensor(a))


@pytest.mark.parametrize("is_bias", [False, True], ids=["weight", "bias"])
def test_create_parameter_shapes_and_initializers(is_bias):
    """The port's parameter, by paddle_tpu's rule (Constant 0 for a bias,
    XavierNormal for a weight).  paddle_tpu's own ``create_parameter``
    is not run: it calls the initializer on the Parameter instead of
    its shape and never returns (ROADMAP section C)."""
    T.seed(3)
    p = T.create_parameter([64, 32], "float32", name="w0", is_bias=is_bias)
    assert isinstance(p, T.Parameter) and p.requires_grad
    assert tuple(p.shape) == (64, 32)
    assert p.dtype == torch.float32 and p.param_name == "w0"
    a = p.detach().numpy()
    if is_bias:
        assert not a.any()
    else:                                   # XavierNormal: std sqrt(2/96)
        assert abs(a.std() / math.sqrt(2.0 / 96) - 1) < 0.1
    c = T.create_parameter([5], "float64", default_initializer=T.nn.
                           initializer.Constant(0.5))
    assert c.dtype == torch.float64 and (c.detach().numpy() == 0.5).all()


@pytest.mark.parametrize("model,size", [("LeNet", [1, 1, 28, 28]),
                                        ("resnet18", [1, 3, 64, 64])])
def test_flops_equal_paddle_tpus(model, size):
    jm = getattr(J.vision.models, model)()
    tm = getattr(T.vision.models, model)()
    want, got = J.flops(jm, size), T.flops(tm, size)
    assert got == want > 0
    assert tm.training                     # left as it was


def test_flops_takes_custom_ops():
    net = T.nn.Sequential(T.nn.Linear(4, 8), T.nn.ReLU())
    got = T.flops(net, [2, 4], custom_ops={T.nn.ReLU: lambda l, i, o: 16})
    assert got == 2 * 4 * 8 + 16


# -- names --------------------------------------------------------------------
def test_top_level_and_ops_helper_names():
    import builtins
    import __future__
    assert T.builtins_slice is builtins.slice is J.builtins_slice
    assert T.annotations is __future__.annotations
    assert T.DataParallel is T.parallel.DataParallel
    assert T.as_array is T.nn.functional.as_array
    assert isinstance(T.next_key(), int)
    assert T.nn.initializer.next_key is T.next_key
    assert T.amp.Tensor is T.Tensor
    assert T.apply(torch.add, T.to_tensor([1.0]), T.to_tensor([2.0]),
                   op_name="add").numpy().tolist() == [3.0]
    for n in ("cond", "case", "switch_case", "while_loop", "sequence",
              "convert_dtype", "get_default_dtype", "paged_attention",
              "paged_attention_supported",
              "register_paged_attention_kernel"):
        assert hasattr(T.ops, n) and hasattr(J.ops, n), n
    assert T.ops.cond is T.cond
    assert T.ops.get_default_dtype() == torch.float32


def test_profiler_hook():
    from paddle_tpu_torch.core import profiler_hook
    assert profiler_hook.current() is None
    marker = object()
    profiler_hook.set_active(marker)
    try:
        assert profiler_hook.current() is marker
    finally:
        profiler_hook.set_active(None)


# -- paged attention ----------------------------------------------------------
def _paged_case(seed, D=128, page=8, H=4, Hkv=2):
    r = np.random.RandomState(seed)
    S, N, P = 3, 10, 3
    q = r.randn(S, H, D).astype(np.float32)
    k = r.randn(N, page, Hkv, D).astype(np.float32)
    v = r.randn(N, page, Hkv, D).astype(np.float32)
    table = r.randint(0, N, (S, P)).astype(np.int32)
    lengths = np.array([5, 24, 1], np.int32)
    return q, k, v, table, lengths


def test_public_paged_attention_equals_paddle_tpus():
    arrs = _paged_case(0)
    want = J.paged_attention(*[J.to_tensor(a) for a in arrs])
    got = T.paged_attention(*[torch.from_numpy(a) for a in arrs])
    assert isinstance(got, T.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.data),
                               rtol=1e-5, atol=1e-6)


def test_paged_attention_supported_has_the_jax_signature():
    q, k = (3, 4, 128), (10, 8, 2, 128)
    # the card's kernel takes D 128, GQA 2 (device defaults to the card)
    assert T.paged_attention_supported(q, k, torch.float32, 8)
    assert not T.paged_attention_supported(q, k, torch.float32, 8, "cpu")
    assert not T.paged_attention_supported((3, 4, 96), (10, 8, 2, 96),
                                           torch.float32, 8)


def test_a_registered_function_only_adds_a_route():
    """Registered, it takes the calls the kernel refuses where
    paddle_tpu's gate would take them (here: CPU tensors at D 128,
    pages of 8), never a call the kernel takes; ``None`` clears it."""
    calls = []

    def fn(q, k_pool, v_pool, page_table, lengths, scale, layer=None):
        calls.append(q.device.type)
        return torch.zeros_like(q)

    arrs = [torch.from_numpy(a) for a in _paged_case(1)]
    plain = T.paged_attention(*arrs).numpy()
    T.register_paged_attention_kernel(fn)
    try:
        assert T.paged_attention_supported((3, 4, 128), (10, 8, 2, 128),
                                           torch.float32, 8, "cpu")
        assert not (T.paged_attention(*arrs).numpy()).any()
        assert calls == ["cpu"]
        odd = [torch.from_numpy(a) for a in _paged_case(2, D=96)]
        T.paged_attention(*odd)            # D 96: the JAX gate refuses
        assert calls == ["cpu"]
        # a call the card's kernel takes stays the kernel's
        assert T.ops.attention.kernel_supported(
            (3, 4, 128), (10, 8, 2, 128), torch.float32, 8, "cuda")
    finally:
        T.register_paged_attention_kernel(None)
    np.testing.assert_array_equal(T.paged_attention(*arrs).numpy(), plain)
    assert not T.paged_attention_supported((3, 4, 128), (10, 8, 2, 128),
                                           torch.float32, 8, "cpu")


# -- ops.pallas on CPU tensors against paddle_tpu's ------------------------
def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


@pytest.mark.parametrize("causal", [False, True])
def test_pallas_flash_and_mha_reference(causal):
    r = np.random.RandomState(4)
    q, k, v = (r.randn(2, 16, 2, 64).astype(np.float32) for _ in range(3))
    want = jpallas.mha_reference(q, k, v, causal=causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    assert _rel(tpallas.mha_reference(tq, tk, tv, causal=causal),
                want) < 1e-5
    out = tpallas.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                                  block_k=128)
    assert _rel(out, want) < 1e-5
    assert tpallas.flash_attention_supported(q.shape, k.shape,
                                             torch.float32, block_q=128)


def test_pallas_fused_epilogue_against_paddle_tpus_interpret_mode():
    stages = (("gelu", True), ("add",))
    r = np.random.RandomState(6)
    x = r.randn(16, 32).astype(np.float32)
    w = (0.3 * r.randn(32, 128)).astype(np.float32)
    b = (0.1 * r.randn(128)).astype(np.float32)
    res = r.randn(16, 128).astype(np.float32)
    want = jpallas.fused_linear_epilogue(x, w, b, stages, (res,),
                                         interpret=True)
    t = [torch.from_numpy(a) for a in (x, w, b, res)]
    got = tpallas.fused_linear_epilogue(t[0], t[1], t[2], stages, (t[3],),
                                        interpret=True)
    assert _rel(got, want) < 1e-5
    assert _rel(tpallas.reference_epilogue(t[0], t[1], t[2], stages,
                                           (t[3],)), want) < 1e-5
    assert tpallas.fused_epilogue_supported(
        x.shape, w.shape, torch.float32, stages, [res.shape]) == \
        jpallas.fused_epilogue_supported(x.shape, w.shape, jnp.float32,
                                         stages, [res.shape])


def test_pallas_fused_adam_against_paddle_tpus_interpret_mode():
    r = np.random.RandomState(7)
    p, g, m = (r.randn(3, 50).astype(np.float32) for _ in range(3))
    v = np.abs(r.randn(3, 50)).astype(np.float32)
    want = jpallas.fused_adam_update(p, g, m, v, 1e-2, 3.0, interpret=True)
    got = tpallas.fused_adam_update(*(torch.from_numpy(a)
                                      for a in (p, g, m, v)), 1e-2, 3.0,
                                    interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    assert tpallas.fused_adam_supported((4,), torch.float32)
    assert not tpallas.fused_adam_supported((4,), torch.bfloat16)


def test_pallas_paged_decode_against_paddle_tpus_interpret_mode():
    arrs = _paged_case(3)
    want = jpallas.paged_attention_decode(*arrs, interpret=True)
    got = tpallas.paged_attention_decode(
        *[torch.from_numpy(a) for a in arrs], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert tpallas.paged_decode_supported((3, 4, 128), (10, 8, 2, 128),
                                          torch.bfloat16, 8)


def test_pallas_kernel_selections_is_the_launch_count_dict():
    assert tpallas.kernel_selections is support.launch_counts
    before = dict(support.launch_counts)
    r = np.random.RandomState(8)
    q = torch.from_numpy(r.randn(1, 8, 1, 32).astype(np.float32))
    tpallas.flash_attention(q, q, q)        # CPU: the plain version
    assert support.launch_counts == before


# -- C8 -----------------------------------------------------------------------
def test_python_if_on_variable_raises_loudly():
    """The twin of ``tests/test_static.py``'s case: the message names
    ``static.nn.cond`` (fault C8)."""
    with T.static.program_guard(T.static.Program()):
        x = T.static.data("x", [2], "float32")
        with pytest.raises(TypeError, match="cond"):
            if x.sum() > 0:
                pass
