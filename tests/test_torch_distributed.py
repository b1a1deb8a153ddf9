"""paddle_tpu_torch's distributed layer held to paddle_tpu's.

One spawn of 4 gloo CPU ranks for the module (``file://`` store under
the test's temporary directory) runs every multi-rank case of the port's
tests:

- the collective API and the differentiable conjugate forms over
  {"dp": 2, "mp": 2} (row-major rank order, as the JAX mesh);
- the fused collective matmuls at mp 2 (the 'mp' lines of {"dp": 2,
  "mp": 2}) and 4, against the JAX package's ``all_gather_matmul`` /
  ``matmul_reduce_scatter`` under ``shard_map`` on the same inputs (f32,
  rtol 1e-5 / atol 1e-4: sums of up to 512 products of unit normals,
  |sum| up to ~30, taken in another order) and bitwise against their own
  oracles: the column ring form against gathering ``w`` and running the
  chunk matmul on all of it, the row ring form against the
  ascending-order sum of every rank's partial.  The JAX package's own
  bitwise test of these (``test_collective_matmul_composite_bitwise_
  oracles``) fails on this tree, so the port is held to the unfused
  product directly;
- ring attention at sp 2 and 4, causal and not, on the flash body (D 32)
  and the plain body (D 8): output and dq/dk/dv against the JAX
  package's ring bodies (``ring_attention_per_device_flash`` /
  ``ring_attention_per_device``, what its ``ring_attention`` runs) under
  ``shard_map`` on an 'sp' mesh of conftest's CPU devices, jitted, and
  against dense attention (its ``reference_attention``), rtol 1e-5 /
  atol 5e-6 (f32; the largest error seen is 1.9e-6, on a gradient
  element near zero);
- the tensor-parallel layers at mp 2 (a vocab that mp does not divide,
  column- and row-parallel linears, the vocab-parallel cross entropy)
  against the JAX package's layers on the same full weights: output and
  loss rtol 1e-5 / atol 1e-6, each shard's gradient against the same
  slice of the JAX gradient rtol 1e-4 / atol 1e-6 (f32, sums in another
  order);
- the slice as a whole: ``build_gpt_hybrid`` at small widths (vocab
  1000, hidden 128, 2 layers, 4 heads, ffn 512, seq 64; f32, dropout 0)
  trained 5 ``SpmdTrainStep``s on {"mp": 2, "sp": 2}, against the JAX
  ``TrainStep`` over ``bench.build_gpt`` (the same composition on one
  device) from the same weights and batch: losses rtol 2e-5 (f32
  forward and backward in other orders, then AdamW), and the replicated
  parameters bit-identical across the mp and sp ranks;
- dropout across 'dp': the same model at dropout 0.5 on {"dp": 2,
  "mp": 2}, both dp halves of the batch identical: the dp ranks' own
  losses differ (each dp rank draws its own masks, as the JAX package
  folds the dp index into its dropout key) and the mp ranks of each dp
  group agree bit for bit (one dp group draws one set of masks);
- batch norm across 'dp': a conv + ``BatchNorm2D`` net at dp 4 takes
  the global batch's statistics, as GSPMD gives the JAX package: the
  normalised output against paddle_tpu's ``F.batch_norm`` on the whole
  batch, the running buffers against paddle_tpu's layer, the gradients
  and 2 ``SpmdTrainStep``s against the net on the whole batch on one
  rank, each within 1e-5 of the reference's largest magnitude (f32
  sums taken in another order; the conv bias before the batch norm has
  gradient 0 up to rounding, held below 1e-6 on both sides), and the
  buffers bit-identical on every rank.

Single-process tests cover the strategy toggles, the launcher's
failure handling and the device defaults.
"""
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.jax_compat import shard_map
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.ops import collective_matmul as jcm
from paddle_tpu.optimizer.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.testing import parallel_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512, seq=64)
GPT_BATCH, GPT_STEPS = 4, 5
TP = dict(vocab=61, hidden=32, ffn=64, classes=16)
# M, K, N of the collective matmul cases: K / 4 and N / 4 still pass the
# gate ("f32", "bf16"); "ungated" has N / n = 32, so the plain matmul runs
CMM_SHAPES = {"f32": (16, 512, 512), "bf16": (16, 512, 512),
              "ungated": (16, 256, 128)}
CMM_TOL = dict(rtol=1e-5, atol=1e-4)
RING = dict(B=2, L=32, H=2)                # ring inputs [B, L, H, D]
RING_TOL = dict(rtol=1e-5, atol=5e-6)
CASES = ["collectives", "data_parallel", "tp_layers", "gpt",
         "collective_matmul", "ring_attention", "dp_dropout",
         "scaler_overflow", "batch_norm_dp", "dp_sparse_embedding"]


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_tp_net():
    """The JAX twin of parallel_cases.case_tp_layers's net."""
    from paddle_tpu import nn
    from paddle_tpu.parallel import (ColumnParallelLinear,
                                     ParallelCrossEntropy, RowParallelLinear,
                                     VocabParallelEmbedding)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = VocabParallelEmbedding(TP["vocab"], TP["hidden"])
            self.col = ColumnParallelLinear(TP["hidden"], TP["ffn"])
            self.row = RowParallelLinear(TP["ffn"], TP["hidden"])
            self.head = ColumnParallelLinear(TP["hidden"], TP["classes"])
            self.ce = ParallelCrossEntropy()

        def forward(self, ids, labels):
            h = self.row(JF.gelu(self.col(self.emb(ids))))
            logits = self.head(h)
            return h, self.ce(logits.reshape([-1, TP["classes"]]),
                              labels.reshape([-1]))

    paddle.seed(17)
    return Net()


def _jax_bn_net():
    """The JAX twin of parallel_cases.case_batch_norm_dp's net."""
    from paddle_tpu import nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 4, 3, padding=1)
            self.bn = nn.BatchNorm2D(4)
            self.fc = nn.Linear(4, 2)

    paddle.seed(31)
    return Net()


def _jax_gpt():
    paddle.seed(2024)
    c = GPT
    return _bench().build_gpt(c["vocab"], c["hidden"], c["layers"],
                              c["heads"], c["ffn"], c["seq"], 0.0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("distributed")
    r = np.random.RandomState(0)
    data = {k: np.asarray(v) for k, v in TP.items()}
    jnet = _jax_tp_net()
    for k, v in jnet.state_dict().items():
        data[f"tp.{k}"] = np.asarray(v.numpy())
    data["ids"] = r.randint(0, TP["vocab"], (4, 6)).astype(np.int64)
    data["labels"] = r.randint(0, TP["classes"], (4, 6)).astype(np.int64)
    data["hw"] = r.randn(4, 6, TP["hidden"]).astype(np.float32)
    gpt = _jax_gpt()
    for k, v in gpt.state_dict().items():
        data[f"gpt.{k}"] = np.asarray(v.numpy())
    for k, v in GPT.items():
        data[f"cfg.{k}"] = np.asarray(v)
    data["gx"] = r.randint(0, GPT["vocab"], (GPT_BATCH, GPT["seq"])
                           ).astype(np.int64)
    data["gy"] = r.randint(0, GPT["vocab"], (GPT_BATCH, GPT["seq"])
                           ).astype(np.int64)
    data["steps"] = np.asarray(GPT_STEPS)
    data["dx"] = r.randn(16, 8).astype(np.float32)
    data["dy"] = r.randn(16, 2).astype(np.float32)
    for k, v in _jax_bn_net().state_dict().items():
        data[f"bn.{k}"] = np.asarray(v.numpy())
    data["bx"] = (r.randn(16, 3, 6, 6) + 0.5).astype(np.float32)
    data["by"] = r.randn(16, 2).astype(np.float32)
    r = np.random.RandomState(31)
    data["se_ids"] = r.randint(0, 30, (16, 5)).astype(np.int64)
    data["se_y"] = r.randn(16, 3).astype(np.float32)
    data["se.emb.weight"] = r.randn(40, 4).astype(np.float32)
    data["se.fc.weight"] = (0.5 * r.randn(4, 3)).astype(np.float32)
    data["se.fc.bias"] = (0.1 * r.randn(3)).astype(np.float32)
    r = np.random.RandomState(21)
    for tag, (m, k, n) in CMM_SHAPES.items():
        data[f"x_{tag}"] = r.randn(m, k).astype(np.float32)
        data[f"w_{tag}"] = r.randn(k, n).astype(np.float32)
    for d in (32, 8):
        for i, a in enumerate("qkvw"):
            data[f"{a}_d{d}"] = np.random.RandomState(100 + 10 * d + i).randn(
                RING["B"], RING["L"], RING["H"], d).astype(np.float32)
    np.savez(out / "inputs.npz", **data)
    spawn(parallel_cases.run, (str(out), CASES), nprocs=4,
          init_method=f"file://{out}/store", timeout=420)
    res = [dict(np.load(out / f"rank{i}.npz")) for i in range(4)]
    return data, jnet, gpt, res


def _case(res, name):
    """Each rank's results of case ``name``, the prefix taken off."""
    return [{k.split("/", 1)[1]: v for k, v in rr.items()
             if k.startswith(name + "/")} for rr in res]


# ------------------------------------------------------- collectives
def test_collective_api_over_mesh_lines(ranks):
    _, _, _, res = ranks
    for r, rr in enumerate(res):
        c = {k.split("/", 1)[1]: v for k, v in rr.items()
             if k.startswith("collectives/")}
        dp, mp = divmod(r, 2)              # row-major: mp varies fastest
        assert list(c["coords"]) == [dp, mp]
        line_mp = [2 * dp, 2 * dp + 1]
        line_dp = [mp, 2 + mp]
        assert (c["all_reduce_world"] == 1 + 2 + 3 + 4).all()
        assert (c["all_reduce_mp_max"] == max(line_mp) + 1).all()
        assert (c["all_reduce_dp_avg"] == np.mean(line_dp) + 1).all()
        np.testing.assert_array_equal(
            c["all_gather_mp"],
            np.repeat([[i + 1.0] for i in line_mp], 3, 1))
        assert int(c["all_gather_parts"]) == 2
        assert (c["broadcast_dp"] == line_dp[1] + 1).all()
        seq = np.arange(8.0).reshape(4, 2)
        np.testing.assert_array_equal(
            c["reduce_scatter_mp"],
            (seq * sum(i + 1 for i in line_mp))[2 * mp:2 * mp + 2])
        np.testing.assert_array_equal(
            c["scatter_mp"], (seq * (line_mp[1] + 1))[2 * mp:2 * mp + 2])
        np.testing.assert_array_equal(
            c["alltoall_mp"], [[10.0 * src + mp] * 2 for src in line_mp])
        assert c["shift_world"][0] == (r - 1) % 4 + 1
        assert c["permute_dp"][0] == (line_dp[0] + 1 if dp == 1 else 0)
        assert c["recv"][0] == (7.0 * (line_mp[0] + 1) if mp == 1 else 0)
        np.testing.assert_array_equal(c["ppermute_grad"],
                                      (r + 1) * np.arange(4.0))
        np.testing.assert_array_equal(c["copy_to_group_grad"],
                                      [sum(i + 1 for i in line_mp)] * 4)
        np.testing.assert_array_equal(c["scatter_to_group_grad"],
                                      [1.0, 3.0, 5.0, 7.0])


# ----------------------------------------------- collective matmuls
def _jax_mesh(n, axis):
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def _jax_col(x, w, n, ring):
    fn = shard_map(lambda wv: jcm.all_gather_matmul(x, wv, "mp", n,
                                                    ring=ring),
                   mesh=_jax_mesh(n, "mp"), in_specs=(P(None, "mp"),),
                   out_specs=P(), check_vma=False)
    return np.asarray(fn(w))


def _jax_row(x, w, n, ring):
    fn = shard_map(lambda xv, wv: jcm.matmul_reduce_scatter(
        xv, wv, "mp", n, ring=ring), mesh=_jax_mesh(n, "mp"),
        in_specs=(P(None, "mp"), P("mp")), out_specs=P("mp"),
        check_vma=False)
    return np.asarray(fn(x, w))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("tag", ["f32", "ungated"])
def test_column_parallel_matches_jax_and_its_oracle_bitwise(ranks, n, tag):
    data, _, _, res = ranks
    x, w = data[f"x_{tag}"], data[f"w_{tag}"]
    want = x.astype(np.float64) @ w.astype(np.float64)
    jgot = _jax_col(jnp.asarray(x), jnp.asarray(w), n, True)
    for rr in _case(res, "collective_matmul"):
        for form in ("ring", "fused"):
            got = rr[f"col_{form}_n{n}_{tag}"]
            np.testing.assert_array_equal(got, rr[f"col_oracle_n{n}_{tag}"])
            np.testing.assert_allclose(got, jgot, **CMM_TOL)
            np.testing.assert_allclose(got, want, **CMM_TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("tag", ["f32", "ungated"])
def test_row_parallel_matches_jax_and_the_ascending_sum(ranks, n, tag):
    data, _, _, res = ranks
    x, w = data[f"x_{tag}"], data[f"w_{tag}"]
    m = x.shape[0] // n
    want = x.astype(np.float64) @ w.astype(np.float64)
    jring = _jax_row(jnp.asarray(x), jnp.asarray(w), n, True)
    for i, rr in enumerate(_case(res, "collective_matmul")):
        idx = i if n == 4 else i % 2
        rows = slice(idx * m, (idx + 1) * m)
        ring = rr[f"row_ring_n{n}_{tag}"]
        # bitwise: the ring sums the partials in ascending member order
        np.testing.assert_array_equal(ring, rr[f"row_oracle_n{n}_{tag}"])
        # the backend's reduce-scatter promises no order: a tolerance
        np.testing.assert_allclose(rr[f"row_fused_n{n}_{tag}"], ring,
                                   **CMM_TOL)
        np.testing.assert_allclose(ring, jring[rows], **CMM_TOL)
        np.testing.assert_allclose(ring, want[rows], **CMM_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_bf16_forms_are_bitwise_to_their_oracles(ranks, n):
    """bf16: each chunk product rounds once (f32 sums); the ring's column
    blocks equal the whole product's, its row sum the bf16 ascending
    sum; both within bf16 rounding of the f32 product."""
    data, _, _, res = ranks
    x, w = (torch.from_numpy(data[f"{a}_bf16"]).bfloat16().double().numpy()
            for a in "xw")
    want = x @ w
    for i, rr in enumerate(_case(res, "collective_matmul")):
        idx = i if n == 4 else i % 2
        m = x.shape[0] // n
        np.testing.assert_array_equal(rr[f"col_ring_n{n}_bf16"],
                                      rr[f"col_oracle_n{n}_bf16"])
        np.testing.assert_array_equal(rr[f"col_fused_n{n}_bf16"],
                                      rr[f"col_oracle_n{n}_bf16"])
        np.testing.assert_array_equal(rr[f"row_ring_n{n}_bf16"],
                                      rr[f"row_oracle_n{n}_bf16"])
        np.testing.assert_allclose(rr[f"col_ring_n{n}_bf16"], want,
                                   rtol=2 ** -7, atol=0.1)
        np.testing.assert_allclose(rr[f"row_ring_n{n}_bf16"],
                                   want[idx * m:(idx + 1) * m],
                                   rtol=2 ** -6, atol=0.3)


@pytest.mark.parametrize("n", [2, 4])
def test_row_parallel_names_a_leading_dim_it_cannot_split(ranks, n):
    for rr in _case(ranks[3], "collective_matmul"):
        msg = str(rr[f"row_error_n{n}"])
        assert "leading dim 5 is not divisible by axis size" in msg, msg


# ------------------------------------------------------ ring attention
def _jax_ring_side(data, d, causal, n):
    """JAX's ring body under shard_map over an 'sp' mesh of n CPU devices
    (the flash body at D 32, the plain body at D 8, as the port picks) and
    the dense reference: output and grads of sum(out * w), jitted."""
    from paddle_tpu.parallel.ring_attention import (
        ring_attention_per_device, ring_attention_per_device_flash)
    body = ring_attention_per_device_flash if d == 32 else \
        ring_attention_per_device
    spec = P(None, "sp", None, None)
    L = RING["L"]
    w = jnp.asarray(data[f"w_d{d}"])

    def ring(q, k, v):
        return shard_map(lambda a, b, c: body(a, b, c, "sp", causal),
                         mesh=_jax_mesh(n, "sp"), in_specs=(spec,) * 3,
                         out_specs=spec, check_vma=False)(q, k, v)

    def ref(q, k, v):
        s = jnp.einsum("blhd,bshd->bhls", q, k) / math.sqrt(d)
        if causal:
            s = jnp.where(jnp.tril(jnp.ones((L, L), bool)), s, -jnp.inf)
        return jnp.einsum("bhls,bshd->blhd", jax.nn.softmax(s, -1), v)

    qkv = [jnp.asarray(data[f"{a}_d{d}"]) for a in "qkv"]
    outs = []
    for fn in (ring, ref):
        def loss(q, k, v, fn=fn):
            o = fn(q, k, v)
            return jnp.sum(o * w), o
        (_, o), g = jax.jit(jax.value_and_grad(loss, (0, 1, 2),
                                               has_aux=True))(*qkv)
        outs.append([np.asarray(o)] + [np.asarray(x) for x in g])
    return outs


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("d", [32, 8], ids=["flash-body", "plain-body"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_jax_ring_and_reference(ranks, n, d, causal):
    data, _, _, res = ranks
    jring, jref = _jax_ring_side(data, d, causal, n)
    key = f"n{n}_d{d}_{'causal' if causal else 'full'}"
    names = ("out", "dq", "dk", "dv")
    res = _case(res, "ring_attention")
    for rr in res:
        got = [rr[f"{name}_{key}"] for name in names]
        for g, a, b in zip(got, jring, jref):
            np.testing.assert_allclose(g, a, **RING_TOL)
            np.testing.assert_allclose(g, b, **RING_TOL)
        # replicated over 'sp': every rank holds the same full result
        for g, name in zip(got, names):
            np.testing.assert_array_equal(g, res[0][f"{name}_{key}"])


# ---------------------------------------------------------- TP layers
def test_tp_layers_match_the_jax_layers(ranks):
    """mp 2: the embedding's 61 rows pad to 62 (31 a rank); every output
    is full and replicated, every gradient the matching slice of the
    JAX gradient (the padding row's is zero)."""
    data, jnet, _, res = ranks
    ids = paddle.to_tensor(data["ids"].astype(np.int32))
    labels = paddle.to_tensor(data["labels"].astype(np.int32))
    for p in jnet.parameters():
        p.stop_gradient = False
    h, loss = jnet(ids, labels)
    (loss + (h * paddle.to_tensor(data["hw"])).sum()).backward()
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in jnet.named_parameters()}
    placements = {"emb.weight": 0, "col.weight": 1, "col.bias": 0,
                  "row.weight": 0, "head.weight": 1, "head.bias": 0}
    # the clip's global norm: the mp-split shares summed over 'mp'
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in jgrads.values()))
    for r, rr in enumerate(res):
        t = {k.split("/", 1)[1]: v for k, v in rr.items()
             if k.startswith("tp_layers/")}
        mp = r % 2
        np.testing.assert_allclose(t["h"], h.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t["loss"], loss.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(t["grad_norm"], norm, rtol=1e-5)
        for name, g in jgrads.items():
            dim = placements.get(name)
            got = t[f"grad.{name}"]
            if dim is not None:
                if name == "emb.weight":
                    g = np.concatenate([g, np.zeros_like(g[:1])])
                g = np.split(g, 2, axis=dim)[mp]
            assert got.shape == g.shape, name
            np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-6,
                                       err_msg=name)


# ------------------------------------------------------ data parallel
def test_data_parallel_averages_gradients_over_dp(ranks):
    """{"dp": 4}: each rank's quarter of the batch; DataParallel's eager
    backward gives the whole batch's gradient (its mean loss), and 3
    SpmdTrainSteps the whole batch's losses (f32, sums in another
    order: 1e-6)."""
    _, _, _, res = ranks
    for rr in res:
        assert float(rr["data_parallel/grad_err"]) <= 1e-6
        np.testing.assert_allclose(rr["data_parallel/losses"],
                                   rr["data_parallel/oracle"], rtol=1e-6)


def test_data_parallel_gathers_a_sparse_embedding_gradient(ranks):
    """{"dp": 4}: ``Embedding(sparse=True)`` under DataParallel.  On
    every rank the sparse gradient holds the whole batch's rows (exactly)
    and values of the mean loss (1e-6), the Linear's gradient is the
    whole batch's, and after 2 lazy Adam steps the parameters are the
    whole batch's (1e-6) and bit-identical on every rank; the rows no
    id touches (30-39) never move."""
    data, _, _, res = ranks
    res = _case(res, "dp_sparse_embedding")
    for rr in res:
        np.testing.assert_array_equal(rr["dp.rows"], rr["oracle.rows"])
        np.testing.assert_allclose(rr["dp.values"], rr["oracle.values"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rr["dp.fc_grad"], rr["oracle.fc_grad"],
                                   rtol=1e-6, atol=1e-6)
        for k in ("emb.weight", "fc.weight", "fc.bias"):
            np.testing.assert_allclose(rr[f"dp.param.{k}"],
                                       rr[f"oracle.param.{k}"],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(rr[f"dp.param.{k}"],
                                          res[0][f"dp.param.{k}"])
        np.testing.assert_array_equal(rr["dp.param.emb.weight"][30:],
                                      data["se.emb.weight"][30:])


def _rel(a, b):
    """max |a - b| over the reference's largest magnitude."""
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / max(np.abs(b).max(), 1e-30))


def _close(a, b):
    """Within 1e-5 of the reference's largest magnitude; the conv bias
    before the batch norm (zeros at the start) has gradient 0 up to
    rounding, since batch norm takes each channel's mean away, so it and
    its gradient stay below 1e-6 on both sides."""
    if np.abs(b).max() <= 1e-6:
        return np.abs(a).max() <= 1e-6
    return _rel(a, b) <= 1e-5


def test_batch_norm_takes_the_global_batch_over_dp(ranks):
    _, _, _, res = ranks
    cs = _case(res, "batch_norm_dp")
    bn_in = np.concatenate([c["bn_in"] for c in cs])
    bn = _jax_bn_net().bn
    want = JF.batch_norm(paddle.to_tensor(bn_in), bn._mean, bn._variance,
                         bn.weight, bn.bias, training=True)
    assert _rel(np.concatenate([c["bn_out"] for c in cs]),
                want.numpy()) <= 1e-5
    bn.train()
    bn(paddle.to_tensor(bn_in))            # moves the JAX layer's buffers
    for c in cs:
        for k in ("_mean", "_variance"):
            assert _rel(c[f"fwd_state.{k}"],
                        getattr(bn, k).numpy()) <= 1e-5
            np.testing.assert_array_equal(c[f"fwd_state.{k}"],
                                          cs[0][f"fwd_state.{k}"])
        grads = [k for k in c if k.startswith("grad.")]
        assert len(grads) == 6
        for k in grads:
            assert _close(c[k], c["oracle_" + k]), k
        np.testing.assert_allclose(c["losses"], c["oracle_losses"],
                                   rtol=1e-5)
        states = [k for k in c if k.startswith("state.")]
        assert len(states) == 8
        for k in states:
            assert _close(c[k], c["oracle_" + k]), k
            np.testing.assert_array_equal(c[k], cs[0][k])


# ------------------------------------------------------ the whole slice
def test_hybrid_gpt_trajectory_matches_the_jax_train_step(ranks):
    data, _, gpt, res = ranks
    c = GPT
    opt = jopt.AdamW(learning_rate=2e-4, parameters=gpt.parameters(),
                     weight_decay=0.01, grad_clip=JaxClip(1.0))

    def loss_fn(out, labels):
        w = paddle.transpose(gpt.tok.weight, [1, 0])
        bias = paddle.zeros([c["vocab"]], dtype=w.dtype)
        return JF.linear_cross_entropy(out.reshape([-1, c["hidden"]]), w,
                                       bias, labels.reshape([-1]))

    step = JaxTrainStep(gpt, loss_fn, opt, n_inputs=1)
    x, y = (jnp.asarray(data[k].astype(np.int32)) for k in ("gx", "gy"))
    jl = [float(step(x, y)) for _ in range(GPT_STEPS)]
    for rr in res:
        np.testing.assert_allclose(rr["gpt/losses"], jl, rtol=2e-5)
    assert jl[-1] < jl[0]
    # replicated parameters: bit-identical on all four ranks; mp-sharded
    # ones identical across the sp ranks that share an mp index
    sharded = (".q.", ".k.", ".v.", ".fc1.", "proj.weight", "fc2.weight")
    for name in (k for k in res[0] if k.startswith("gpt/param.")):
        split = any(s in name for s in sharded)
        for r in range(4):                 # rank = 2 * mp + sp
            same = res[(r // 2) * 2] if split else res[0]
            np.testing.assert_array_equal(res[r][name], same[name],
                                          err_msg=name)
    # and the trained weights agree with the JAX model's
    jw = {k: np.asarray(v.numpy()) for k, v in gpt.state_dict().items()}
    for name in ("tok.weight", "blocks.1.ln2.weight", "ln_f.bias"):
        np.testing.assert_allclose(res[0][f"gpt/param.{name}"], jw[name],
                                   rtol=0, atol=2e-5, err_msg=name)


def test_dropout_masks_differ_across_dp_and_agree_across_mp(ranks):
    """Rank 2 dp + mp.  Both dp halves of the batch are the same tokens,
    so only the masks can tell the dp ranks' losses apart."""
    _, _, _, res = ranks
    losses = [rr["dp_dropout/local_losses"] for rr in res]
    assert all(len(l) == 2 and np.isfinite(l).all() for l in losses)
    for dp in range(2):
        np.testing.assert_array_equal(losses[2 * dp], losses[2 * dp + 1])
    assert (losses[0] != losses[2]).all()


def test_spmd_scaler_skips_an_overflow_on_every_rank(ranks):
    """One rank's overflow (rank 0's labels at dp 4, rank 0's column
    shard at dp 2 x mp 2) skips the step on all four ranks: every rank
    keeps its parameters and halves the scale, then applies the next
    step with the same scale; at dp 4 the result is the single-process
    TrainStep's on the whole batch."""
    _, _, _, res = ranks
    sc = [_case(res, "scaler_overflow")[r] for r in range(4)]
    for rr in sc:
        for mesh in ("dp", "mp"):
            np.testing.assert_array_equal(rr[f"{mesh}.params0"],
                                          rr[f"{mesh}.init"], err_msg=mesh)
            assert float(rr[f"{mesh}.scale0"]) == 512.0, mesh
            assert float(rr[f"{mesh}.scale1"]) == 1024.0, mesh
            assert not np.array_equal(rr[f"{mesh}.params1"],
                                      rr[f"{mesh}.params0"]), mesh
        np.testing.assert_allclose(rr["dp.params1"], rr["dp.oracle"],
                                   rtol=1e-6, atol=1e-7)
        assert float(rr["dp.oracle_scale"]) == 1024.0
        np.testing.assert_array_equal(rr["dp.params1"], sc[0]["dp.params1"])
    # the row layer's bias is replicated over 'mp': equal on all ranks
    nb = 2
    for rr in sc:
        np.testing.assert_array_equal(rr["mp.params1"][-nb:],
                                      sc[0]["mp.params1"][-nb:])


# -------------------------------------------------- single process
def test_strategy_toggles_not_ported_raise_naming_them():
    from paddle_tpu_torch.distributed.strategy import (DistributedStrategy,
                                                       validate_toggles)
    # dgc and a_sync are not carried, as in paddle_tpu
    for name in ("dgc", "a_sync"):
        s = DistributedStrategy()
        setattr(s, name, True)
        with pytest.raises(NotImplementedError, match=name):
            validate_toggles(s)
    # ZeRO and the grad_comm stage are ported (slice A5a), gradient
    # merge, recompute, amp, pipeline and LocalSGD too (slice A5b)
    for name in ("sharding", "fp16_allreduce", "gradient_merge",
                 "recompute", "amp", "pipeline", "localsgd",
                 "adaptive_localsgd"):
        s = DistributedStrategy()
        setattr(s, name, True)
        validate_toggles(s)
    s = DistributedStrategy()
    s.grad_comm = {"dtype": "int8"}
    validate_toggles(s)
    s = DistributedStrategy()
    s.tensor_parallel = True
    s.tensor_parallel_configs = {"tensor_parallel_degree": 2}
    s.sequence_parallel = True
    s.sequence_parallel_configs = {"sp_degree": 2}
    assert s.infer_mesh_shape(8) == {"dp": 2, "sp": 2, "mp": 2}
    with pytest.raises(ValueError, match="divide"):
        validate_toggles(s, n_devices=6)
    validate_toggles(s, n_devices=4)


def test_spawn_ends_the_other_ranks_when_one_fails():
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed: 3"):
        spawn(parallel_cases.exit_on_rank, (1, 3, 60.0), nprocs=2,
              timeout=50)
    assert time.monotonic() - t0 < 40


def test_defaults_are_the_card_and_the_cpu_is_asked_for():
    """Without a GPU, init_parallel_env() and the TP layers refuse the
    default device (the card); device="cpu" takes gloo; a world of one
    needs no rendezvous."""
    import subprocess
    import sys
    code = (
        "import torch, pytest\n"
        "import torch.distributed as dist\n"
        "from paddle_tpu_torch import distributed as d\n"
        "from paddle_tpu_torch.parallel import ColumnParallelLinear\n"
        "assert not torch.cuda.is_available()\n"
        "with pytest.raises(RuntimeError, match='CUDA'):\n"
        "    d.init_parallel_env()\n"
        "with pytest.raises(RuntimeError, match='CUDA'):\n"
        "    ColumnParallelLinear(8, 8)\n"
        "mesh = d.init_parallel_env(device='cpu')\n"
        "assert dist.get_backend() == 'gloo' and mesh.shape == {'dp': 1}\n"
        "assert d.get_rank() == 0 and d.get_world_size() == 1\n"
        "assert d.ParallelEnv().nranks == 1\n"
        "with pytest.raises(ValueError, match='multiply'):\n"
        "    d.init_mesh({'dp': 2})\n"
        "dist.destroy_process_group()\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "MASTER_ADDR")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_single_rank_layers_are_plain_layers():
    """No process group: the TP layers are ordinary linears (mp of one),
    and the sharding helper hands the full arrays through."""
    from paddle_tpu_torch.framework_io import shard_state_from_paddle_tpu
    from paddle_tpu_torch.parallel import (ColumnParallelLinear,
                                           RowParallelLinear)
    tdist.set_mesh(None)
    col = ColumnParallelLinear(16, 128, device="cpu")
    row = RowParallelLinear(128, 16, device="cpu")
    x = torch.randn(3, 5, 16)
    y = row(torch.relu(col(x)))
    want = torch.relu(x @ col.weight + col.bias) @ row.weight + row.bias
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
    full = {"weight": np.ones((16, 128), np.float32)}
    assert shard_state_from_paddle_tpu(full, col)["weight"].shape == (16, 128)
    from paddle_tpu_torch.parallel import split
    assert split(x, (16, 32), "linear", axis=1).shape == (3, 5, 32)
    assert split(x, (16, 32), "linear", axis=0).shape == (3, 5, 32)
    ids = torch.tensor([[1, 5], [9, 0]])
    assert split(ids, (10, 4), "embedding").shape == (2, 2, 4)
    with pytest.raises(ValueError, match="unsupported"):
        split(x, (16, 32), "conv")
