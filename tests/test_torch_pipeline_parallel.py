"""Slice A5b's multi-rank half held to paddle_tpu: the pipeline, LocalSGD,
the row-sharded embedding, the strategy toggles on SpmdTrainStep and the
hybrid {dp, mp} static Executor.

One module-scoped world of 4 gloo CPU ranks runs every case
(``testing.pipeline_cases``; spawned once, with a timeout, so a hang in
a rank's collectives fails the module instead of stalling the run).  The
same seeded inputs go through paddle_tpu on the first 4 of the 8 virtual
CPU devices, on the same mesh shape:

- ``tests/test_distributed.py``'s pipeline cases ({pp: 4} forward and
  gradients, and {pp: 4, dp: 2} with an embedding and a head, which
  becomes {pp: 2, dp: 2}): forward rtol 1e-4 / atol 1e-5, gradients
  rtol 1e-3 / atol 1e-5, against paddle_tpu and against the stages run
  in turn;
- ``tests/test_pipeline_memory.py``'s three claims, with the bytes kept
  for the backward (``saved_tensors_hooks`` and the recomputed segments'
  inputs) in place of XLA's temp bytes: remat keeps under half of what
  the plain schedule keeps, grows close to linearly in M, and gives the
  plain schedule's numbers;
- part E of ``__graft_entry__.dryrun_multichip`` (embedding + blocks
  over 'pp' + head, batch over 'dp', two Adam steps): the losses, and
  the bytes a rank holds for its stage (its block and the block's
  slots) equal to one stage's;
- ``tests/test_strategy_toggles.py``'s LocalSGD cases at dp 4 against
  the numpy oracle and paddle_tpu (rtol 1e-4), and its recompute toggle;
  ``tests/test_trainstep_features.py``'s gradient merge;
- ``tests/test_sparse.py``'s SPMD parity of ShardedEmbedding (the rank's
  untouched rows bit for bit);
- the hybrid {dp: 2, mp: 2} Executor: comm_smoke's GPT-tiny with every
  2-D weight cut over 'mp' (losses and parameters after 3 steps at rtol
  1e-4 against paddle_tpu's Executor with an fp32 wire; comm_smoke's
  int8 gates, measured == predicted bytes on each axis), the overlap
  matrix row of ``tests/test_distributed.py`` and the runtime half of
  ``tests/test_static_analysis.py``'s hybrid case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn, optimizer
from paddle_tpu import distributed as jdist
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.testing import pipeline_cases, sharding_cases

WORLD = 4
SPAWN_TIMEOUT_S = 420
# the card's multi-card pipeline leg (chip_smoke.py --multicard) at small
# widths: 8 blocks, 2 a stage over 4 ranks, 8 microbatches of one row
P1B = dict(vocab=257, hidden=64, layers=8, heads=4, ffn=256, seq=32,
           microbatches=8, dropout=0.0)


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return jdist.init_mesh(dict(shape), devices=jax.devices()[:n])


def _arr(t):
    return np.asarray(t.data if hasattr(t, "data") else t)


def _save_layer(data, prefix, layer):
    for n, p in layer.named_parameters():
        data[prefix + n] = _arr(p)


# ------------------------------------------------ paddle_tpu's references
def _jax_pipeline(data):
    from paddle_tpu.parallel import pipelined_fn, stack_stage_params
    ref = {}
    _jmesh({"pp": 4})
    paddle.seed(5)
    stages = [nn.Linear(8, 8) for _ in range(4)]
    for i, s in enumerate(stages):
        _save_layer(data, f"seq.s{i}.", s)
    stacked, _ = stack_stage_params(stages)
    x = np.random.RandomState(5).randn(16, 8).astype(np.float32)
    data["seq.x"] = x
    ref["seq.out"] = np.asarray(jax.jit(pipelined_fn(nn.Linear(8, 8), 4, 4))(
        stacked, jnp.asarray(x)))

    stages = [nn.Linear(4, 4) for _ in range(4)]
    for i, s in enumerate(stages):
        _save_layer(data, f"diff.s{i}.", s)
    stacked, _ = stack_stage_params(stages)
    fn = pipelined_fn(nn.Linear(4, 4), 4, num_microbatches=2)
    x = np.random.rand(8, 4).astype(np.float32)
    data["diff.x"] = x
    gs, gx = jax.jit(jax.grad(lambda ps, xx: jnp.sum(fn(ps, xx) ** 2),
                              argnums=(0, 1)))(stacked, jnp.asarray(x))
    ref["diff.g"] = [np.asarray(g) for g in gs]
    ref["diff.gx"] = np.asarray(gx)

    mesh = _jmesh({"pp": 2, "dp": 2})
    paddle.seed(9)
    stages = [nn.Linear(8, 8) for _ in range(2)]
    embed, head = nn.Embedding(32, 8), nn.Linear(8, 32)
    for i, s in enumerate(stages):
        _save_layer(data, f"eh.s{i}.", s)
    _save_layer(data, "eh.embed.", embed)
    _save_layer(data, "eh.head.", head)
    from paddle_tpu.jit.bind import param_list
    stacked, _ = stack_stage_params(stages)
    ep = tuple(p.data for p in param_list(embed))
    hp = tuple(p.data for p in param_list(head))
    fn = pipelined_fn(nn.Linear(8, 8), n_stages=2, num_microbatches=4,
                      mesh=mesh, dp_axis="dp", embed_layer=embed,
                      head_layer=head)
    ids = np.random.RandomState(0).randint(0, 32, (16, 6)).astype(np.int64)
    data["eh.ids"] = ids
    def out_and_grads(a, b, c):
        return fn(a, jnp.asarray(ids), b, c), jax.grad(
            lambda a2, b2, c2: jnp.sum(fn(a2, jnp.asarray(ids), b2, c2) ** 2),
            argnums=(0, 1, 2))(a, b, c)

    out, (gs, ge, gh) = jax.jit(out_and_grads)(stacked, ep, hp)
    ref["eh.out"] = np.asarray(out)
    ref["eh.gs"] = [np.asarray(g) for g in gs]
    ref["eh.ge"] = [np.asarray(g) for g in ge]
    ref["eh.gh"] = [np.asarray(g) for g in gh]
    return ref


def _jax_memory_numerics(data):
    from paddle_tpu.parallel import pipeline_train_fn, stack_stage_params
    _jmesh({"pp": 4})
    paddle.seed(9)
    stages = [nn.Sequential(*[nn.Linear(64, 64) for _ in range(10)])
              for _ in range(4)]
    for s, seq in enumerate(stages):
        _save_layer(data, f"num.s{s}.", seq)
    stacked, _ = stack_stage_params(stages)
    r = np.random.RandomState(9)
    x = r.randn(32, 64).astype(np.float32)
    y = r.randn(32, 64).astype(np.float32)
    data["num.x"], data["num.y"] = x, y
    fn = pipeline_train_fn(stages[0], lambda o, yy: jnp.mean((o - yy) ** 2),
                           4, 8, remat=True)
    loss, g = jax.jit(jax.value_and_grad(lambda p: fn(p, x, y)))(stacked)
    return {"loss": float(loss), "g0": np.asarray(g[0]),
            "g_last": np.asarray(g[-1])}


def _jax_gpt(data):
    from paddle_tpu.jit.bind import param_list
    from paddle_tpu.parallel.pipeline import pipelined_fn, \
        stack_stage_params
    mesh = _jmesh({"pp": 2, "dp": 2})
    paddle.seed(31)
    H, V = 16, 64

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(H)
            self.attn_qkv = nn.Linear(H, H)
            self.mlp = nn.Linear(H, H)

        def forward(self, h):
            return h + self.mlp(JF.gelu(self.attn_qkv(self.ln(h))))

    blocks = [Block() for _ in range(2)]
    embed, head = nn.Embedding(V, H), nn.Linear(H, V)
    for s, b in enumerate(blocks):
        _save_layer(data, f"gpt.b{s}.", b)
    _save_layer(data, "gpt.embed.", embed)
    _save_layer(data, "gpt.head.", head)
    stacked, _ = stack_stage_params(blocks)
    ep = tuple(p.data for p in param_list(embed))
    hp = tuple(p.data for p in param_list(head))
    pipe = pipelined_fn(blocks[0], 2, num_microbatches=4, mesh=mesh,
                        dp_axis="dp", embed_layer=embed, head_layer=head)
    ids = np.random.RandomState(41).randint(0, V, (16, 6)).astype(np.int64)
    lab = np.random.RandomState(42).randint(0, V, (16, 6)).astype(np.int64)
    data["gpt.ids"], data["gpt.lab"] = ids, lab

    def loss_fn(sp, e, h):
        logp = jax.nn.log_softmax(pipe(sp, jnp.asarray(ids), e, h), axis=-1)
        return jnp.mean(-jnp.take_along_axis(
            logp, jnp.asarray(lab)[..., None], axis=-1))

    flat, tree = jax.tree.flatten((stacked, ep, hp))
    ms = [jnp.zeros_like(p) for p in flat]
    vs = [jnp.zeros_like(p) for p in flat]
    losses = []
    vg = jax.jit(jax.value_and_grad(
        lambda f: loss_fn(*jax.tree.unflatten(tree, f))))
    for t in range(1, 3):
        loss, grads = vg(flat)
        b1, b2, eps, lr = 0.9, 0.999, 1e-8, 0.01
        new = []
        for k, (p, g) in enumerate(zip(flat, grads)):
            ms[k] = b1 * ms[k] + (1 - b1) * g
            vs[k] = b2 * vs[k] + (1 - b2) * g * g
            mh, vh = ms[k] / (1 - b1 ** t), vs[k] / (1 - b2 ** t)
            new.append(p - lr * mh / (jnp.sqrt(vh) + eps))
        flat = new
        losses.append(float(loss))
    return losses


def _toy(data, tag, seed, din=4, dout=3, bs=16):
    paddle.seed(seed)
    net = nn.Linear(din, dout)
    _save_layer(data, f"{tag}.net.", net)
    r = np.random.RandomState(seed)
    data[f"{tag}.x"] = r.randn(bs, din).astype(np.float32)
    data[f"{tag}.y"] = r.randn(bs, dout).astype(np.float32)
    return (net, jnp.asarray(data[f"{tag}.x"]), jnp.asarray(data[f"{tag}.y"]),
            lambda o, lab: JF.mse_loss(o, lab))


def _jax_localsgd(data):
    from paddle_tpu.distributed.strategy import DistributedStrategy
    from paddle_tpu.parallel import LocalSGDTrainStep, SpmdTrainStep
    _jmesh({"dp": WORLD})
    ref = {}

    def strat(adaptive=False, **cfg):
        s = DistributedStrategy()
        if adaptive:
            s.adaptive_localsgd = True
            s.adaptive_localsgd_configs = cfg
        else:
            s.localsgd = True
            s.localsgd_configs = cfg
        return s

    net, x, y, loss_fn = _toy(data, "oracle", 7)
    step = LocalSGDTrainStep(net, loss_fn, optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()),
        strategy=strat(k_steps=3, begin_step=2))
    ref["oracle.losses"] = [float(step(x, y)) for _ in range(7)]
    step.sync_to_model()
    ref["oracle.w"], ref["oracle.b"] = _arr(net.weight), _arr(net.bias)

    net, x, y, loss_fn = _toy(data, "k1", 11)
    step = LocalSGDTrainStep(net, loss_fn, optimizer.SGD(
        learning_rate=0.05, parameters=net.parameters()),
        strategy=strat(k_steps=1, begin_step=0))
    for _ in range(4):
        step(x, y)
    step.sync_to_model()
    ref["k1.local"] = _arr(net.weight)

    net, x, y, loss_fn = _toy(data, "diverge", 13)
    step = LocalSGDTrainStep(net, loss_fn, optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()),
        strategy=strat(k_steps=4, begin_step=0))
    step(x, y)
    ref["diverge.rep"] = np.asarray(step._p_rep[0])

    net, x, y, loss_fn = _toy(data, "adaptive", 17)
    step = LocalSGDTrainStep(net, loss_fn, optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()),
        strategy=strat(True, init_k_steps=4, begin_step=2))
    ks, losses = [], []
    for _ in range(12):
        losses.append(float(step(x, y)))
        ks.append(step.k_steps)
    ref["adaptive.ks"], ref["adaptive.losses"] = ks, losses

    net, x, y, loss_fn = _toy(data, "fleet", 19)
    from paddle_tpu.distributed.fleet import Fleet
    f = Fleet()
    s = DistributedStrategy()
    s.localsgd = True
    f.init(strategy=s)
    _jmesh({"dp": WORLD})
    f.distributed_optimizer(optimizer.SGD(learning_rate=0.1,
                                          parameters=net.parameters()))
    step = f.get_train_step(net, loss_fn)
    ref["fleet.losses"] = [float(step(x, y)) for _ in range(2)]

    net, x, y, loss_fn = _toy(data, "ckpt", 41)
    opt = optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    step = LocalSGDTrainStep(net, loss_fn, opt, strategy=strat(
        k_steps=2, begin_step=0))
    for _ in range(3):
        step(x, y)
    sd = opt.state_dict()
    step.sync_to_model()
    w3 = _arr(net.weight).copy()
    for _ in range(2):
        step(x, y)
    net.weight.data = paddle.to_tensor(w3).data
    opt.set_state_dict(sd)
    ref["ckpt.loss"] = float(step(x, y))

    # SpmdTrainStep toggles at dp 4
    net, x, y, loss_fn = _toy(data, "rc", 29)
    s = DistributedStrategy()
    s.recompute = True
    step = SpmdTrainStep(net, loss_fn, optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()), strategy=s)
    ref["rc.losses"] = [float(step(x, y)) for _ in range(3)]
    net, x, y, loss_fn = _toy(data, "gm", 12, din=4, dout=2, bs=8)
    s = DistributedStrategy()
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 2}
    step = SpmdTrainStep(net, loss_fn, optimizer.SGD(
        learning_rate=0.05, parameters=net.parameters()), strategy=s)
    ref["gm.losses"] = [float(step(x, y)) for _ in range(80)]
    return ref


def _localsgd_oracle(w0, b0, x, y, lr, dp, k_steps, begin, n_steps):
    """``tests/test_strategy_toggles.py``'s numpy oracle: per-replica SGD
    on its batch shard, the mean every step during the warm-up, then
    every k steps."""
    W = [w0.copy() for _ in range(dp)]
    B = [b0.copy() for _ in range(dp)]
    xs = x.reshape(dp, -1, x.shape[1])
    ys = y.reshape(dp, -1, y.shape[1])
    last = 0
    for t in range(1, n_steps + 1):
        for r in range(dp):
            e = xs[r] @ W[r] + B[r] - ys[r]
            n = e.size
            W[r] = W[r] - lr * (2.0 / n * xs[r].T @ e)
            B[r] = B[r] - lr * (2.0 / n * e.sum(0))
        if (t <= begin) or (t - last >= k_steps):
            Wm, Bm = np.mean(W, 0), np.mean(B, 0)
            W = [Wm.copy() for _ in range(dp)]
            B = [Bm.copy() for _ in range(dp)]
            last = t
    return np.mean(W, 0), np.mean(B, 0)


def _jax_sharded_embedding(data):
    from paddle_tpu.jit import TrainStep
    from paddle_tpu.parallel import ShardedEmbedding, SpmdTrainStep
    mesh = _jmesh({"dp": WORLD})
    paddle.seed(4)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = ShardedEmbedding(64, 8, axis="dp")
            self.fc = nn.Linear(8, 4)

        def forward(self, ids):
            return self.fc(self.emb(ids).mean(axis=1))

    net = Net()
    data["emb.weight"] = _arr(net.emb.weight).copy()
    _save_layer(data, "emb.fc.", net.fc)
    init = {k: _arr(v).copy() for k, v in net.state_dict().items()}
    ids = np.random.RandomState(0).randint(0, 16, (8, 4)).astype(np.int64)
    y = np.random.RandomState(1).randint(0, 4, (8,)).astype(np.int64)
    data["emb.ids"], data["emb.y"] = ids, y
    loss_fn = lambda out, lab: JF.cross_entropy(out, lab)  # noqa: E731
    step = SpmdTrainStep(net, loss_fn, optimizer.Adam(
        learning_rate=0.05, parameters=net.parameters()), mesh=mesh)
    spmd = [float(step(jnp.asarray(ids, jnp.int32),
                       jnp.asarray(y, jnp.int32))) for _ in range(2)]
    net.set_state_dict(init)
    local = TrainStep(net, loss_fn, optimizer.Adam(
        learning_rate=0.05, parameters=net.parameters()))
    loc = [float(local(jnp.asarray(ids, jnp.int32),
                       jnp.asarray(y, jnp.int32))) for _ in range(2)]
    return {"spmd": spmd, "local": loc}


def _jax_hybrid(feed, steps=3):
    """``tools/comm_smoke._train``'s hybrid row on {dp: 2, mp: 2} at an
    fp32 wire (every 2-D weight cut over 'mp', comm_smoke's seed): the
    program's weights and constants, the losses, and the parameters
    after the steps."""
    import re
    from tools.shard_smoke import build_gpt_tiny
    shape = {"dp": 2, "mp": 2}
    paddle.enable_static()
    try:
        _jmesh(shape)
        paddle.seed(7)
        main, loss, _ = build_gpt_tiny()
        ws = [np.asarray(p.data).copy() for p in main.parameters()]
        cs = [np.asarray(v) for node in main.nodes
              for tag, v in node.in_specs if tag == "c"]
        with paddle.static.program_guard(main):
            s = jdist.DistributedStrategy()
            s.fuse_grad_size_in_MB = 0.05
            s.grad_comm = {"dtype": "fp32", "error_feedback": True,
                           "block_size": 256, "scatter_threshold_KB": 4.0,
                           "overlap": "auto"}
            jdist.fleet.init(is_collective=True, strategy=s)
            opt = jdist.fleet.distributed_optimizer(
                optimizer.AdamW(learning_rate=1e-3))
            opt.minimize(loss)
        _jmesh(shape)
        main._sharding_rules = [
            (re.escape(p.name) + "$", (None, "mp"))
            for p in main.parameters() if len(p.data.shape) == 2
        ] + [(r".*", ())]
        exe = paddle.static.Executor()
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                  for _ in range(steps)]
        exe.close()
        params = np.concatenate([np.asarray(p.data, np.float32).ravel()
                                 for p in main.parameters()])
    finally:
        paddle.disable_static()
        paddle.static.reset_default_programs()
    return ws, cs, losses, params


def _fc_adam_oracle(w, b, feed, steps=3, lr=1e-2):
    """The fc program's full-batch mse under paddle's Adam (float64):
    the losses of ``steps`` runs from ``w``, ``b``."""
    x = feed["x"].astype(np.float64)
    y = feed["y"].astype(np.float64)
    params = [w.astype(np.float64), b.astype(np.float64)]
    m = [np.zeros_like(p) for p in params]
    v = [np.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for t in range(1, steps + 1):
        e = x @ params[0] + params[1] - y
        losses.append(float(np.mean(e ** 2)))
        grads = [2.0 / e.size * x.T @ e, 2.0 / e.size * e.sum(0)]
        for k, g in enumerate(grads):
            m[k] = b1 * m[k] + (1 - b1) * g
            v[k] = b2 * v[k] + (1 - b2) * g * g
            lr_t = lr * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
            params[k] = params[k] - lr_t * m[k] / (
                np.sqrt(v[k]) + eps * np.sqrt(1 - b2 ** t))
    return losses


def _fc_feed():
    rng = np.random.RandomState(1)
    xs = rng.standard_normal((64, 8)).astype(np.float32)
    return {"x": xs, "y": (xs @ rng.standard_normal((8, 1))).astype(
        np.float32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_parallel")
    data, ref = {}, {}
    try:
        ref["pipeline"] = _jax_pipeline(data)
        ref["memory"] = _jax_memory_numerics(data)
        ref["gpt"] = _jax_gpt(data)
        ref["localsgd"] = _jax_localsgd(data)
        ref["emb"] = _jax_sharded_embedding(data)
        ws, cs, losses, params = _jax_hybrid(sharding_cases.gpt_feeds())
        ref["hybrid"] = (losses, params)
        data.update({f"w{i}": w for i, w in enumerate(ws)})
        data.update({f"c{i}": c for i, c in enumerate(cs)})
        data.update(n_weights=len(ws), n_constants=len(cs))
        data.update(sharding_cases.gpt_feeds())
        feed = _fc_feed()
        data["fc_x"], data["fc_y"] = feed["x"], feed["y"]
        r = np.random.RandomState(7)
        data["fcpp_w"] = (0.3 * r.standard_normal((8, 1))).astype(np.float32)
        data["fcpp_b"] = np.zeros((1,), np.float32)
        ref["static_pp"] = _fc_adam_oracle(data["fcpp_w"], data["fcpp_b"],
                                           feed)
    finally:
        jdist.init_mesh({"dp": 8})
    r = np.random.RandomState(18)
    ids, lab = (r.randint(0, P1B["vocab"], (8, P1B["seq"])).astype(np.int64)
                for _ in range(2))
    data.update(pipeline_cases.p1b_inputs(P1B, ids, lab, steps=3))
    np.savez(out / "inputs.npz", **data)
    spawn(pipeline_cases.run, (str(out), list(pipeline_cases.CASES)),
          nprocs=WORLD, init_method=f"file://{out}/store",
          timeout=SPAWN_TIMEOUT_S)
    res = [dict(np.load(out / f"rank{i}.npz")) for i in range(WORLD)]
    return data, ref, res


def _g(res, key, rank=0):
    return res[rank][key]


# ------------------------------------------------------------- pipeline
def _seq_oracle_grads(ws, bs, x):
    """The stages in turn (plain torch), loss sum(out**2): the output,
    each stage's weight and bias gradients, and the input's."""
    W = [torch.tensor(w, dtype=torch.float64, requires_grad=True)
         for w in ws]
    B = [torch.tensor(b, dtype=torch.float64, requires_grad=True)
         for b in bs]
    x = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    h = x
    for w, b in zip(W, B):
        h = h @ w + b
    (h ** 2).sum().backward()
    return (h.detach().numpy(), [w.grad.numpy() for w in W],
            [b.grad.numpy() for b in B], x.grad.numpy())


def test_pipeline_matches_sequential(world):
    """``test_pipeline_matches_sequential`` on {pp: 4}: every rank's
    output equals paddle_tpu's pipeline and the stages in turn (rtol
    1e-4, atol 1e-5); each rank holds one stage's block."""
    data, ref, res = world
    ws = [data[f"seq.s{i}.weight"] for i in range(4)]
    bs = [data[f"seq.s{i}.bias"] for i in range(4)]
    expect = _seq_oracle_grads(ws, bs, data["seq.x"])[0]
    for r in range(WORLD):
        out = _g(res, "pipeline/seq.out", r)
        np.testing.assert_allclose(out, ref["pipeline"]["seq.out"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)
        assert tuple(_g(res, "pipeline/seq.block_shape", r)) == (1, 8, 8)


def test_pipeline_is_differentiable(world):
    """``test_pipeline_is_differentiable``: each rank's gradients of its
    stage block equal paddle_tpu's block and the sequential oracle's
    (rtol 1e-3, atol 1e-5), finite and not all zero; so does the
    input's gradient (the owner's broadcast sends each microbatch's
    cotangent back to the rank that holds it, and the ranks' shares of
    the replicated input sum over 'pp'), on every rank."""
    data, ref, res = world
    ws = [data[f"diff.s{i}.weight"] for i in range(4)]
    bs = [data[f"diff.s{i}.bias"] for i in range(4)]
    _, gw, gb, gx = _seq_oracle_grads(ws, bs, data["diff.x"])
    jw, jb = ref["pipeline"]["diff.g"]
    for r in range(WORLD):
        got_x = _g(res, "pipeline/diff.gx", r)
        assert np.abs(got_x).sum() > 0
        np.testing.assert_allclose(got_x, ref["pipeline"]["diff.gx"],
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got_x, gx, rtol=1e-3, atol=1e-5)
        i = int(_g(res, "pipeline/diff.stage", r))
        got_w = _g(res, "pipeline/diff.gw", r)[0]
        got_b = _g(res, "pipeline/diff.gb", r)[0]
        for got, j, o in ((got_w, jw[i], gw[i]), (got_b, jb[i], gb[i])):
            assert np.isfinite(got).all() and np.abs(got).sum() > 0
            np.testing.assert_allclose(got, j, rtol=1e-3, atol=1e-5)
            np.testing.assert_allclose(got, o, rtol=1e-3, atol=1e-5)


def test_pipeline_dp_sharded_with_embed_head(world):
    """``test_pipeline_dp_sharded_with_embed_head`` on {pp: 2, dp: 2}:
    the output [16, 6, 32] against paddle_tpu and the sequential oracle
    (rtol 1e-4, atol 1e-5); the gradients of each rank's stage block and
    of the replicated embedding and head against paddle_tpu's (rtol
    1e-3, atol 1e-5), alike on every rank for the replicated ones, none
    all zero."""
    data, ref, res = world
    j = ref["pipeline"]
    ids = data["eh.ids"]
    h = torch.tensor(data["eh.embed.weight"], dtype=torch.float64)[
        torch.from_numpy(ids)]
    for i in range(2):
        h = h @ torch.tensor(data[f"eh.s{i}.weight"], dtype=torch.float64) \
            + torch.tensor(data[f"eh.s{i}.bias"], dtype=torch.float64)
    h = h @ torch.tensor(data["eh.head.weight"], dtype=torch.float64) \
        + torch.tensor(data["eh.head.bias"], dtype=torch.float64)
    for r in range(WORLD):
        out = _g(res, "pipeline/eh.out", r)
        assert out.shape == (16, 6, 32)
        np.testing.assert_allclose(out, j["eh.out"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out, h.numpy(), rtol=1e-4, atol=1e-5)
        i = int(_g(res, "pipeline/eh.stage", r))
        for key, jg in (("eh.gw", j["eh.gs"][0][i]),
                        ("eh.gb", j["eh.gs"][1][i]),
                        ("eh.ge", j["eh.ge"][0]),
                        ("eh.ghw", j["eh.gh"][0]),
                        ("eh.ghb", j["eh.gh"][1])):
            got = _g(res, f"pipeline/{key}", r)
            got = got[0] if key in ("eh.gw", "eh.gb") else got
            assert np.abs(got).sum() > 0, key
            np.testing.assert_allclose(got, jg, rtol=1e-3, atol=1e-5,
                                       err_msg=key)


def test_remat_cuts_backward_memory_by_depth_factor(world):
    """``test_remat_cuts_backward_memory_by_depth_factor``: with remat a
    tick keeps one boundary activation, not all ten sublayers' inputs:
    under half the bytes of the plain schedule at M = 8, on every
    rank."""
    _, _, res = world
    for r in range(WORLD):
        t_remat = _g(res, "pipeline_memory/bytes.M8.remat", r)
        t_plain = _g(res, "pipeline_memory/bytes.M8.plain", r)
        assert 0 < t_remat < t_plain / 2, (t_remat, t_plain)


def test_remat_memory_grows_linearly_with_small_constant(world):
    """``test_remat_memory_grows_linearly_with_small_constant``: doubling
    M (microbatch fixed) grows the kept bytes by under 2.6x."""
    _, _, res = world
    for r in range(WORLD):
        t16 = _g(res, "pipeline_memory/bytes.M16.remat", r)
        t32 = _g(res, "pipeline_memory/bytes.M32.remat", r)
        assert t32 / max(t16, 1) < 2.6, (t16, t32)


def test_remat_numerics_match_unrematted(world):
    """``test_remat_numerics_match_unrematted``: the loss (rtol 1e-5)
    and the stage gradients (rtol 1e-4, atol 1e-6) with remat equal the
    plain schedule's, and paddle_tpu's (loss rtol 1e-4, gradients rtol
    1e-3, atol 1e-5)."""
    _, ref, res = world
    j = ref["memory"]
    for r in range(WORLD):
        g = lambda k: _g(res, f"pipeline_memory/num.{k}", r)  # noqa: E731
        np.testing.assert_allclose(g("remat.loss"), g("plain.loss"),
                                   rtol=1e-5)
        np.testing.assert_allclose(g("remat.loss"), j["loss"], rtol=1e-4)
        for k in ("g0", "g_last"):
            np.testing.assert_allclose(g(f"remat.{k}"), g(f"plain.{k}"),
                                       rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g("remat.g0")[0], j["g0"][r],
                                   rtol=1e-3, atol=1e-5)


def test_gpt_shaped_pipeline_trains_and_holds_one_stage(world):
    """Part E of the dryrun on {pp: 2, dp: 2}: two Adam steps' losses
    against paddle_tpu's (rtol 1e-4), finite and falling, alike on every
    rank; each rank holds one stage's parameters and its slots for them
    (Adam's two moments), not the whole stack."""
    _, ref, res = world
    for r in range(WORLD):
        losses = _g(res, "pipeline_gpt/losses", r)
        assert np.isfinite(losses).all() and losses[1] < losses[0]
        np.testing.assert_allclose(losses, ref["gpt"], rtol=1e-4)
        stage = _g(res, "pipeline_gpt/stage_param_bytes", r)
        assert _g(res, "pipeline_gpt/block_param_bytes", r) == stage
        assert _g(res, "pipeline_gpt/block_slot_bytes", r) == 2 * stage


def test_pipelined_gpt_over_four_stages_matches_one(world):
    """The multi-card leg of ``chip_smoke.py`` at small widths: the
    pipelined GPT (8 blocks, 2 a stage on {pp: 4}, 8 microbatches, f32,
    3 AdamW steps) gives the losses of the same model as one stage at
    world size 1 (rtol 1e-4); each rank holds one stage's block and its
    two Adam moments, and the embedding and head whole."""
    from paddle_tpu_torch.core import placement
    from paddle_tpu_torch import distributed as tdist
    data, _, res = world
    prev = placement.default()
    placement.set_default(torch.device("cpu"))
    tdist.set_mesh(None)
    try:
        one = pipeline_cases.pipeline_gpt_train(
            P1B, torch.from_numpy(data["p1b.ids"]),
            torch.from_numpy(data["p1b.labels"]), 3, torch.device("cpu"))
    finally:
        tdist.set_mesh(None)
        placement.set_default(prev)
    assert one["block_param_bytes"] == one["stage_param_bytes"]
    for r in range(WORLD):
        g = lambda k: _g(res, "pipeline_1b/" + k, r)  # noqa: E731
        np.testing.assert_allclose(g("losses"), one["losses"], rtol=1e-4)
        stage = g("stage_param_bytes")
        assert 4 * stage == one["stage_param_bytes"]
        assert g("block_param_bytes") == stage
        assert g("block_slot_bytes") == 2 * stage
        assert g("replicated_param_bytes") == one["replicated_param_bytes"]


# -------------------------------------------------------------- LocalSGD
def test_localsgd_matches_numpy_oracle(world):
    """``test_localsgd_matches_numpy_oracle`` at dp 4 (k 3, begin 2, 7
    SGD steps): the synced weights against the numpy oracle and
    paddle_tpu (rtol 1e-4, atol 1e-5), the losses against paddle_tpu's
    (rtol 1e-4)."""
    data, ref, res = world
    j = ref["localsgd"]
    We, Be = _localsgd_oracle(data["oracle.net.weight"],
                              data["oracle.net.bias"], data["oracle.x"],
                              data["oracle.y"], 0.1, WORLD, 3, 2, 7)
    for r in range(WORLD):
        w = _g(res, "localsgd/oracle.w", r)
        b = _g(res, "localsgd/oracle.b", r)
        for got, o, jj in ((w, We, j["oracle.w"]), (b, Be, j["oracle.b"])):
            np.testing.assert_allclose(got, o, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got, jj, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_g(res, "localsgd/oracle.losses", r),
                                   j["oracle.losses"], rtol=1e-4)


def test_localsgd_k1_equals_plain_dp(world):
    """``test_localsgd_k1_equals_plain_dp``: k 1 syncs every step, as the
    data-parallel SpmdTrainStep (SGD on a linear model: the mean of the
    gradients is the mean of the parameters), and as paddle_tpu's."""
    _, ref, res = world
    for r in range(WORLD):
        local = _g(res, "localsgd/k1.local", r)
        np.testing.assert_allclose(local, _g(res, "localsgd/k1.dp", r),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(local, ref["localsgd"]["k1.local"],
                                   rtol=1e-4, atol=1e-5)


def test_localsgd_diverges_between_syncs(world):
    """``test_localsgd_diverges_between_syncs``: at k 4 the replicas part
    after one step (no sync), each as paddle_tpu's replica of that
    rank."""
    _, ref, res = world
    reps = np.stack([_g(res, "localsgd/diverge.replica", r)
                     for r in range(WORLD)])
    assert np.abs(reps - reps.mean(0, keepdims=True)).max() > 1e-6
    np.testing.assert_allclose(reps, ref["localsgd"]["diverge.rep"],
                               rtol=1e-4, atol=1e-6)


def test_adaptive_localsgd_adapts_k(world):
    """``test_adaptive_localsgd_adapts_k``: k within [1, 16], shrinking
    from 4 on this convex problem and not constant, the same k after
    every step as paddle_tpu's, losses at rtol 1e-4."""
    _, ref, res = world
    for r in range(WORLD):
        ks = _g(res, "localsgd/adaptive.ks", r).tolist()
        assert _g(res, "localsgd/adaptive.flag", r) == 1
        assert all(1 <= k <= 16 for k in ks)
        assert ks[-1] <= 4 and len(set(ks)) > 1
        assert ks == ref["localsgd"]["adaptive.ks"]
        np.testing.assert_allclose(_g(res, "localsgd/adaptive.losses", r),
                                   ref["localsgd"]["adaptive.losses"],
                                   rtol=1e-4)


def test_fleet_routes_localsgd(world):
    """``test_fleet_routes_localsgd``: ``fleet.get_train_step`` gives a
    LocalSGDTrainStep under ``strategy.localsgd``; the loss falls, as
    paddle_tpu's (rtol 1e-4)."""
    _, ref, res = world
    for r in range(WORLD):
        assert str(_g(res, "localsgd/fleet.kind", r)) == "LocalSGDTrainStep"
        losses = _g(res, "localsgd/fleet.losses", r)
        assert losses[1] < losses[0]
        np.testing.assert_allclose(losses, ref["localsgd"]["fleet.losses"],
                                   rtol=1e-4)


def test_localsgd_optimizer_checkpoint_roundtrip(world):
    """``test_localsgd_optimizer_checkpoint_roundtrip``: the optimizer's
    state_dict counts 3 steps; ``set_state_dict`` drops the replicas, so
    the loaded weights win: the next step is the 4th and its loss is
    paddle_tpu's (rtol 1e-4)."""
    _, ref, res = world
    for r in range(WORLD):
        assert _g(res, "localsgd/ckpt.sd_step", r) == 3
        assert _g(res, "localsgd/ckpt.dropped", r) == 1
        assert _g(res, "localsgd/ckpt.aux_step", r) == 4
        np.testing.assert_allclose(_g(res, "localsgd/ckpt.loss", r),
                                   ref["localsgd"]["ckpt.loss"], rtol=1e-4)


# -------------------------------------------- the row-sharded embedding
def test_sharded_embedding_spmd_parity(world):
    """``test_sharded_embedding_spmd_parity`` at dp 4: each rank holds 16
    of the 64 rows; the SPMD losses equal the dense single-device
    step's (rtol 2e-4) and paddle_tpu's; the rows no id reached are
    unchanged bit for bit, the touched ones moved."""
    data, ref, res = world
    touched = np.unique(data["emb.ids"].reshape(-1))
    for r in range(WORLD):
        spmd = _g(res, "sharded_embedding/spmd.losses", r)
        np.testing.assert_allclose(
            spmd, _g(res, "sharded_embedding/local.losses", r), rtol=2e-4)
        np.testing.assert_allclose(spmd, ref["emb"]["spmd"], rtol=2e-4)
        np.testing.assert_allclose(
            _g(res, "sharded_embedding/local.losses", r),
            ref["emb"]["local"], rtol=2e-4)
        assert tuple(_g(res, "sharded_embedding/global_shape", r)) == (64, 8)
        before = _g(res, "sharded_embedding/rows_before", r)
        after = _g(res, "sharded_embedding/rows_after", r)
        assert before.shape == (16, 8)
        rows = np.arange(r * 16, (r + 1) * 16)
        hit = np.isin(rows, touched)
        np.testing.assert_array_equal(after[~hit], before[~hit])
        if hit.any():
            assert not np.allclose(after[hit], before[hit])


# ----------------------------------------------------- strategy toggles
def test_recompute_toggle_matches_at_dp4(world):
    """``test_recompute_toggle_remats_and_matches``: ``strategy.recompute``
    turns the step's recompute on and leaves the losses of the plain
    step (rtol 1e-5) and paddle_tpu's (rtol 1e-5)."""
    _, ref, res = world
    for r in range(WORLD):
        assert _g(res, "toggles/rc.flag", r) == 1
        losses = _g(res, "toggles/rc.losses", r)
        np.testing.assert_allclose(losses, _g(res, "toggles/rc.base", r),
                                   rtol=1e-5)
        np.testing.assert_allclose(losses, ref["localsgd"]["rc.losses"],
                                   rtol=1e-5)


def test_spmd_gradient_merge_from_strategy(world):
    """``test_spmd_gradient_merge_from_strategy`` at dp 4:
    ``strategy.gradient_merge`` (k 2) makes 2 accumulation micro-batches
    a step; 80 steps halve the loss, as paddle_tpu's (rtol 1e-4)."""
    _, ref, res = world
    for r in range(WORLD):
        assert _g(res, "toggles/gm.accumulate", r) == 2
        losses = _g(res, "toggles/gm.losses", r)
        assert losses[-1] < losses[0] * 0.5
        np.testing.assert_allclose(losses, ref["localsgd"]["gm.losses"],
                                   rtol=1e-4)


# ------------------------------------------------ the hybrid {dp, mp} step
def test_hybrid_executor_matches_paddle_tpu(world):
    """comm_smoke's hybrid rows on {dp: 2, mp: 2} (GPT-tiny, every 2-D
    weight cut over 'mp'): at an fp32 wire the losses and parameters
    after 3 steps equal paddle_tpu's Executor on the same mesh (rtol
    1e-4; the key biases, whose gradient is zero up to rounding, within
    lr a step, as the card-vs-CPU phases hold them)."""
    data, ref, res = world
    losses, params = ref["hybrid"]
    # the key projection's bias (the middle third of each block's qkv
    # bias) moves every score of a row alike, which the softmax cancels:
    # its gradient is rounding noise, which AdamW turns into steps of up
    # to lr either way, so it is held within lr a step
    key = np.zeros(params.shape, bool)
    off = 0
    for i in range(int(data["n_weights"])):
        shape = data[f"w{i}"].shape
        n = int(np.prod(shape))
        if shape == (3 * sharding_cases.H,):
            key[off + sharding_cases.H:off + 2 * sharding_cases.H] = True
        off += n
    assert key.sum() == 2 * sharding_cases.H
    for r in range(WORLD):
        np.testing.assert_allclose(_g(res, "hybrid/fp32.losses", r), losses,
                                   rtol=1e-4)
        got = _g(res, "hybrid/fp32.params", r)
        np.testing.assert_allclose(got[~key], params[~key], rtol=1e-4,
                                   atol=1e-6)
        assert np.abs(got[key] - params[key]).max() <= 1e-3 * 3


def test_hybrid_comm_gates(world):
    """comm_smoke's int8 gates on the hybrid mesh: int8 wire bytes under
    0.35x fp32's on 'dp'; measured == predicted bytes on each axis
    ('dp', 'mp') and for the mp gather leg, in both overlap modes; the
    mp axis carries gather traffic; int8 losses within 2e-3 of fp32's;
    one build each; a rank holds the per-shard price of its params
    between runs."""
    _, _, res = world
    g = lambda k, r=0: _g(res, "hybrid/" + k, r)  # noqa: E731
    fp32 = g("fp32.losses")
    assert g("int8_auto.wire_bytes_per_step") < \
        0.35 * g("fp32.wire_bytes_per_step")
    for tag in ("fp32", "int8_auto", "int8_none"):
        assert g(f"{tag}.compiles") == 1
        assert g(f"{tag}.wire_bytes_per_step") == \
            g(f"{tag}.predicted_wire_bytes"), tag
        assert g(f"{tag}.axis_dp_wire_bytes") == \
            g(f"{tag}.predicted_axis_dp"), tag
        assert g(f"{tag}.axis_mp_wire_bytes") == \
            g(f"{tag}.predicted_axis_mp") > 0, tag
        assert g(f"{tag}.gather_wire_bytes_per_step") == \
            g(f"{tag}.predicted_gather_wire_bytes") > 0, tag
        assert g(f"{tag}.resident_param_bytes") == \
            g(f"{tag}.predicted_param_bytes"), tag
        if tag != "fp32":
            np.testing.assert_allclose(g(f"{tag}.losses"), fp32, atol=2e-3)
        for r in range(1, WORLD):
            np.testing.assert_array_equal(g(f"{tag}.params", r),
                                          g(f"{tag}.params"))


def test_hybrid_overlap_matrix_row_and_lint(world):
    """``test_grad_comm_overlap_axis_matrix_recompiles_as_new_sharding``'s
    hybrid row (an mp-cut fc weight, resting as its half): one build,
    and the overlap flip one rebuild named new_sharding; and
    ``test_hybrid_mesh_static_and_runtime_both_accept``'s runtime half
    (its static half is the shard checker's, not ported): a finite
    loss, one build."""
    _, _, res = world
    for r in range(WORLD):
        g = lambda k: _g(res, "hybrid/" + k, r)  # noqa: E731
        assert g("matrix.compiles0") == 1 and g("matrix.compiles1") == 2
        assert str(g("matrix.cause")) == "new_sharding"
        assert tuple(g("matrix.resting_shape")) == (4, 1)
        assert np.isfinite([g("matrix.l0"), g("matrix.l1")]).all()
        assert np.isfinite(g("lint.l0")) and g("lint.compiles") == 1


def test_hybrid_dropout_masks_agree_across_mp(world):
    """Dropout under the hybrid {dp: 2, mp: 2} Executor folds in the dp
    index only: the two mp ranks of a dp group draw the same masks, so
    after 3 runs every rank holds the same parameters (the replicated
    ones included) and losses; the cut weight rests as its half.  A
    global-norm clip over an mp-cut weight is refused (its norm would
    be the chunk's)."""
    _, _, res = world
    g = lambda k, r: _g(res, "hybrid_dropout/" + k, r)  # noqa: E731
    assert tuple(g("resting_shape", 0)) == (8, 8)
    assert np.isfinite(g("losses", 0)).all()
    for r in range(1, WORLD):
        np.testing.assert_array_equal(g("params", r), g("params", 0))
        np.testing.assert_array_equal(g("losses", r), g("losses", 0))
    # a clip's norm over this rank's chunk would be wrong: refused
    for r in range(WORLD):
        assert "mp-cut" in str(g("clip_refusal", r))


def test_static_executor_replicates_over_pp(world):
    """A fleet program without grad_comm on {dp: 2, pp: 2}: the 'pp'
    ranks hold replicas, as GSPMD runs paddle_tpu's, and each dp group
    its half of the batch: 3 runs' losses equal the full-batch Adam
    oracle's (rtol 1e-5), on every rank."""
    _, ref, res = world
    for r in range(WORLD):
        np.testing.assert_allclose(_g(res, "static_pp/losses", r),
                                   ref["static_pp"], rtol=1e-5)
