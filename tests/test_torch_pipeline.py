"""Slice A5b's single-process half held to paddle_tpu: the pipelined GPT
at world size 1 (the slice's main path at small widths), the pipeline's
stage bookkeeping, the row-sharded embedding without a mesh axis, and
the refusals of LocalSGD and of the F-then-B schedule.  The multi-rank
half is ``tests/test_torch_pipeline_parallel.py``.

The pipelined GPT: paddle_tpu's ``bench.build_gpt`` blocks as one stage
of ``pipeline_train_fn`` (an embedding first stage and an untied head
last, 2 microbatches, remat on, dropout 0) on a {pp: 1} mesh, and the
port's ``testing.models.build_gpt_pipeline`` from the same weights: the
loss at rtol 1e-4 and every gradient at rtol 1e-3 / atol 1e-5, then
three AdamW steps' losses at rtol 1e-4, and the port's pipeline against
its own stages run in turn.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import nn
from paddle_tpu import distributed as jdist
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.core import placement

CFG = dict(vocab=257, hidden=64, layers=2, heads=4, ffn=256, seq=32,
           dropout=0.0)


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    pt.set_device("cpu")
    dist.set_mesh(None)
    yield
    dist.set_mesh(None)
    placement.set_default(prev)


def _jax_gpt_pipeline(batch, steps):
    """paddle_tpu's pipelined GPT: bench.build_gpt's blocks as the stage,
    its token and position embeddings, a LayerNorm + untied Linear head;
    the loss and gradients of the first batch, then AdamW's losses."""
    import bench
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.jit.bind import param_list
    from paddle_tpu.parallel import pipeline_train_fn, stack_stage_params
    c = CFG
    jdist.init_mesh({"pp": 1}, devices=jax.devices()[:1])
    try:
        paddle.seed(11)
        model = bench.build_gpt(c["vocab"], c["hidden"], c["layers"],
                                c["heads"], c["ffn"], c["seq"], 0.0)

        class Embed(nn.Layer):
            def __init__(self):
                super().__init__()
                self.tok, self.pos = model.tok, model.pos

            def forward(self, ids):
                pos = paddle.arange(ids.shape[1]).unsqueeze(0)
                return self.tok(ids) + self.pos(pos)

        class Head(nn.Layer):
            def __init__(self):
                super().__init__()
                self.ln_f = model.ln_f
                self.out = nn.Linear(c["hidden"], c["vocab"])

            def forward(self, x):
                return self.out(self.ln_f(x))

        stage = nn.Sequential(*model.blocks)
        embed, head = Embed(), Head()
        weights = {"stage": {k: np.asarray(v.data) for k, v in
                             stage.state_dict().items()},
                   "embed": {k: np.asarray(v.data) for k, v in
                             embed.state_dict().items()},
                   "head": {k: np.asarray(v.data) for k, v in
                            head.state_dict().items()}}
        stacked, _ = stack_stage_params([stage])
        ep = tuple(p.data for p in param_list(embed))
        hp = tuple(p.data for p in param_list(head))

        def head_fn(logits, y):
            return JF.cross_entropy(
                paddle.Tensor(logits.reshape(-1, c["vocab"])),
                paddle.Tensor(y.reshape(-1))).data

        fn = pipeline_train_fn(stage, head_fn, 1, 2, embed_layer=embed,
                               head_layer=head, remat=True)
        ids, lab = batch
        vg = jax.value_and_grad(lambda s, e, h: fn(s, ids, lab, e, h),
                                argnums=(0, 1, 2))
        # AdamW (paddle_tpu's functional update), steps from the start
        from paddle_tpu import optimizer as jopt
        flat = list(stacked) + list(ep) + list(hp)
        opt = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01)
        state = opt.functional_init(flat)
        n_s, n_e = len(stacked), len(ep)

        @jax.jit
        def train(flat, state, t):
            loss, g = vg(flat[:n_s], tuple(flat[n_s:n_s + n_e]),
                         tuple(flat[n_s + n_e:]))
            flat, state = opt.functional_update(
                flat, list(g[0]) + list(g[1]) + list(g[2]), state,
                jnp.float32(1e-3), t)
            return loss, g, flat, state

        out, losses = {}, []
        for t in range(1, steps + 1):
            loss, g, flat, state = train(flat, state, jnp.float32(t))
            losses.append(float(loss))
            if t == 1:      # the loss and gradients at the start
                out.update(loss=float(loss), grads=[
                    [np.asarray(x) for x in part] for part in g])
        out["losses"] = losses
        return weights, out
    finally:
        jdist.init_mesh({"dp": 8})


def _port_gpt_pipeline(weights):
    from paddle_tpu_torch.parallel import pipeline_train_fn, \
        stack_stage_params
    from paddle_tpu_torch.testing.models import (build_gpt_pipeline,
                                                 gpt_pipeline_loss)
    c = CFG
    dist.init_mesh({"pp": 1})
    stage, embed, head = build_gpt_pipeline(
        c["vocab"], c["hidden"], c["layers"], c["heads"], c["ffn"],
        c["seq"], c["dropout"], device="cpu")
    for layer, key in ((stage, "stage"), (embed, "embed"), (head, "head")):
        layer.load_state_dict({k: torch.from_numpy(v.copy())
                               for k, v in weights[key].items()})
    stacked, n = stack_stage_params([stage])
    fn = pipeline_train_fn(stage, gpt_pipeline_loss(c["vocab"]), 1, 2,
                           embed_layer=embed, head_layer=head, remat=True)
    return stage, embed, head, stacked, n, fn


def _batch():
    r = np.random.RandomState(3)
    ids = r.randint(0, CFG["vocab"], (4, CFG["seq"])).astype(np.int64)
    lab = r.randint(0, CFG["vocab"], (4, CFG["seq"])).astype(np.int64)
    return ids, lab


def test_pipelined_gpt_at_world_one_matches_paddle_tpu():
    """The slice's main path at small widths: the pipelined GPT's loss
    (rtol 1e-4) and the gradients of the stage block, the embedding and
    the head (rtol 1e-3, atol 1e-5) against paddle_tpu's; three AdamW
    steps' losses at rtol 1e-4; the pipeline's loss equals the port's
    stages run in turn (rtol 1e-5)."""
    from paddle_tpu_torch import optimizer
    ids, lab = _batch()
    weights, ref = _jax_gpt_pipeline((jnp.asarray(ids), jnp.asarray(lab)),
                                     3)
    stage, embed, head, stacked, n, fn = _port_gpt_pipeline(weights)
    ep, hp = tuple(embed.parameters()), tuple(head.parameters())
    x, y = torch.from_numpy(ids), torch.from_numpy(lab)
    loss = fn(stacked, x, y, ep, hp)
    loss.backward()
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-4)
    got = [[p.grad.numpy()[0] for p in stacked],
           [p.grad.numpy() for p in ep], [p.grad.numpy() for p in hp]]
    for part, jpart in zip(got, ref["grads"]):
        assert len(part) == len(jpart)
        for g, jg in zip(part, jpart):
            jg = jg[0] if jg.shape != g.shape else jg
            np.testing.assert_allclose(g, jg, rtol=1e-3, atol=1e-5)
    with torch.no_grad():
        seq = head(stage(embed(x)))
        plain = torch.nn.functional.cross_entropy(
            seq.reshape(-1, CFG["vocab"]), y.reshape(-1))
    np.testing.assert_allclose(float(loss), float(plain), rtol=1e-5)
    for p in list(stacked) + list(ep) + list(hp):
        p.grad = None
    opt = optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                          parameters=list(stacked) + list(ep) + list(hp))
    losses = []
    for _ in range(3):
        loss = fn(stacked, x, y, ep, hp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)


def test_stack_stage_params_keeps_this_ranks_block():
    """``stack_stage_params``: one new leaf a parameter, stacked on a new
    leading axis (copies: the stages may be dropped), ``global_shape``
    the whole stack; non-uniform stages and a stage count the 'pp' axis
    does not divide raise; ``pipelined_fn`` runs one stage a rank."""
    from paddle_tpu_torch.parallel import (Pipeline, PipelineStage,
                                           pipelined_fn,
                                           stack_stage_params)
    dist.init_mesh({"pp": 1})
    pt.seed(3)
    stages = [pt.nn.Linear(4, 4) for _ in range(3)]
    stacked, n = stack_stage_params(stages)
    assert n == 2 and tuple(stacked[0].shape) == (3, 4, 4)
    assert stacked[0].global_shape == (3, 4, 4) and stacked[0].is_leaf
    np.testing.assert_array_equal(stacked[0][1].detach().numpy(),
                                  stages[1].weight.detach().numpy())
    assert stacked[0].data_ptr() != stages[0].weight.data_ptr()
    with pytest.raises(ValueError, match="uniform"):
        stack_stage_params([pt.nn.Linear(4, 4), pt.nn.LayerNorm(4),
                            pt.nn.Sequential()])
    with pytest.raises(ValueError, match="one stage a rank"):
        pipelined_fn(stages[0], 3, 2)
    pipe = Pipeline([PipelineStage(s) for s in stages], num_microbatches=2)
    x = torch.randn(2, 4)
    ref = x
    for s in stages:
        ref = s(ref)
    np.testing.assert_allclose(pipe(x).detach().numpy(),
                               ref.detach().numpy(), rtol=1e-6)


def test_sharded_embedding_eager_sparse_grad():
    """``test_sharded_embedding_eager_sparse_grad``: without the mesh
    axis the table is whole and its gradient is SelectedRows, as
    paddle_tpu's."""
    from paddle_tpu.core.selected_rows import SelectedRows as JSR
    from paddle_tpu.parallel import ShardedEmbedding as JSE
    from paddle_tpu_torch.core.selected_rows import SelectedRows, sparse_grad
    from paddle_tpu_torch.core.tensor import raw_grad
    from paddle_tpu_torch.parallel import ShardedEmbedding
    paddle.seed(3)
    je = JSE(32, 4, axis="nope_axis")
    jids = paddle.to_tensor(np.array([[1, 2]], np.int64))
    je(jids).sum().backward()
    assert isinstance(je.weight._grad_data, JSR)
    pt.seed(3)
    emb = ShardedEmbedding(32, 4, axis="nope_axis")
    assert tuple(emb.weight.shape) == (32, 4)
    emb(torch.tensor([[1, 2]])).sum().backward()
    g = sparse_grad(raw_grad(emb.weight))
    assert isinstance(g, SelectedRows)
    np.testing.assert_array_equal(np.sort(np.asarray(g.rows)), [1, 2])


def test_sharded_embedding_refuses_an_indivisible_vocab_and_offload():
    """The divisibility error names the vocab and the axis (paddle_tpu's
    words); ``offload`` warns and keeps the table in device memory, as
    paddle_tpu does on a backend without memory kinds."""
    from paddle_tpu.distributed.mesh import init_mesh as jinit
    from paddle_tpu.parallel import ShardedEmbedding as JSE
    from paddle_tpu_torch.parallel import ShardedEmbedding
    jinit({"dp": 8})
    with pytest.raises(ValueError, match="divisible") as je:
        JSE(30, 4, axis="dp")
    from paddle_tpu_torch.distributed.mesh import Mesh
    mesh = Mesh.__new__(Mesh)
    mesh.shape, mesh.axis_names = {"dp": 8}, ("dp",)
    dist.set_mesh(mesh)
    with pytest.raises(ValueError, match="divisible") as te:
        ShardedEmbedding(30, 4, axis="dp")
    assert str(te.value) == str(je.value)
    dist.set_mesh(None)
    with pytest.warns(UserWarning, match="device memory"):
        emb = ShardedEmbedding(32, 4, offload="pinned_host")
    assert emb.weight.device.type == "cpu"


def test_localsgd_rejects_silently_droppable_toggles():
    """``test_localsgd_rejects_silently_droppable_toggles``: LocalSGD
    with sharding (and float16 amp) raises naming it, as paddle_tpu's."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed.strategy import DistributedStrategy as JS
    from paddle_tpu.parallel import LocalSGDTrainStep as JL
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.parallel import LocalSGDTrainStep
    for S, L, mk, opt in ((JS, JL, nn.Linear, jopt),
                          (DistributedStrategy, LocalSGDTrainStep,
                           pt.nn.Linear, optimizer)):
        net = mk(4, 3)
        s = S()
        s.localsgd = True
        s.sharding = True
        o = opt.SGD(learning_rate=0.1, parameters=net.parameters())
        with pytest.raises(NotImplementedError, match="sharding"):
            L(net, lambda a, b: a, o, strategy=s)
        s = S()
        s.localsgd = True
        s.amp = True
        s.amp_configs = {"dtype": "float16"}
        with pytest.raises(NotImplementedError, match="float16"):
            L(net, lambda a, b: a, o, strategy=s)


def test_localsgd_at_world_one_is_the_plain_step():
    """One replica: LocalSGD through ``fleet.get_train_step`` syncs over
    one rank, so its losses and weights are ``TrainStep``'s (AdamW, 4
    steps, rtol 1e-6); ``state_dict`` reads the synced weights."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.parallel import LocalSGDTrainStep
    F = pt.nn.functional
    r = np.random.RandomState(5)
    x = torch.from_numpy(r.randn(8, 4).astype(np.float32))
    y = torch.from_numpy(r.randn(8, 3).astype(np.float32))
    pt.seed(5)
    net = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                           pt.nn.Linear(8, 3))
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    f = dist.Fleet()
    s = dist.DistributedStrategy()
    s.localsgd = True
    s.localsgd_configs = {"k_steps": 2, "begin_step": 1}
    f.init(strategy=s)
    f.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-2, parameters=net.parameters()))
    step = f.get_train_step(net, lambda o, l: F.mse_loss(o, l))
    assert isinstance(step, LocalSGDTrainStep)
    got = [float(step(x, y)) for _ in range(4)]
    w = {k: v.detach().clone() for k, v in net.state_dict().items()}
    net.set_state_dict(init)
    base = TrainStep(net, lambda o, l: F.mse_loss(o, l), optimizer.AdamW(
        learning_rate=1e-2, parameters=net.parameters()))
    want = [float(base(x, y)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(w[k].numpy(), v.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_schedule_mode_f_then_b_raises():
    """``test_schedule_mode_f_then_b_raises``: F-then-B under pipeline
    raises, 1F1B passes, an unknown mode is a ValueError, on both
    packages."""
    from paddle_tpu.distributed.strategy import DistributedStrategy as JS
    from paddle_tpu.distributed.strategy import validate_toggles as jv
    from paddle_tpu_torch.distributed.strategy import (DistributedStrategy,
                                                       validate_toggles)
    for S, v in ((JS, jv), (DistributedStrategy, validate_toggles)):
        s = S()
        s.pipeline = True
        s.pipeline_configs.schedule_mode = "F-then-B"
        with pytest.raises(NotImplementedError, match="F-then-B"):
            v(s)
        s.pipeline_configs.schedule_mode = "1F1B"
        v(s)
        s.pipeline_configs.schedule_mode = "zigzag"
        with pytest.raises(ValueError, match="schedule_mode"):
            v(s)
