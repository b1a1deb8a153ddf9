"""Multi-rank cases of pipeline parallelism, LocalSGD, the row-sharded
embedding, the strategy toggles on ``SpmdTrainStep`` and the hybrid
{dp, mp} static Executor, run inside ranks started by
:func:`~..distributed.launch.spawn` (the tests on the CPU over gloo, four
ranks; ``chip_smoke.py --multicard`` over NCCL).

Each case installs its own mesh (every rank in the same order), builds
its layers from the weights the caller saved (``inputs.npz``, keys
prefixed by the case name) and returns what it computed; :func:`run`
saves each rank's results to ``rank<r>.npz`` (a dict-valued result
flattened to ``case/key``).  A rank imports ``torch`` and this package
only.
"""
from __future__ import annotations

import importlib
import os
from typing import Dict

import numpy as np
import torch

__all__ = ["run", "CASES", "saved_bytes", "pipeline_gpt_parts",
           "pipeline_gpt_train", "p1b_inputs"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _load(layer, data, prefix):
    """``layer``'s parameters from ``data[prefix + name]``."""
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(_t(data[prefix + n]))


def _mesh(shape):
    from ..distributed import init_mesh
    return init_mesh(dict(shape))


def _linears(data, prefix, n, din, dout):
    from .. import nn
    out = []
    for i in range(n):
        lin = nn.Linear(din, dout)
        _load(lin, data, f"{prefix}{i}.")
        out.append(lin)
    return out


def saved_bytes(fn, live=()):
    """Bytes ``fn()`` saves for its backward: the distinct storages the
    autograd graph keeps (``saved_tensors_hooks``) plus the inputs each
    recomputed segment keeps to run again, leaving out the storages of
    ``live`` (parameters and inputs, which live anyway).  Returns
    ``(fn(), bytes)``."""
    # the module (the package exports the function under its name)
    rc = importlib.import_module("..parallel.recompute", __package__)
    skip = {t.untyped_storage().data_ptr() for t in live}
    seen: Dict[int, int] = {}

    def note(t):
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = st.nbytes()

    def pack(t):
        note(t)
        return t

    orig = rc.checkpoint

    def counted(function, *args, **kw):
        for a in args:
            note(a)
        return orig(function, *args, **kw)

    rc.checkpoint = counted
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn()
    finally:
        rc.checkpoint = orig
    return out, sum(seen.values())


# ------------------------------------------------------------- pipeline
def case_pipeline(data, device) -> Dict[str, object]:
    """``tests/test_distributed.py``'s pipeline cases: the forward
    against the stages in turn ({pp: 4}), the gradients of ``sum(out**2)``
    ({pp: 4}, 2 microbatches), and the {pp: 2, dp: 2} grid with an
    embedding first stage and a head last stage (output and the
    gradients of the stage block, the embedding and the head)."""
    from .. import nn
    from ..parallel import pipelined_fn, stack_stage_params
    out = {}
    mesh = _mesh({"pp": 4})
    i = mesh.axis_index("pp")
    stages = _linears(data, "seq.s", 4, 8, 8)
    stacked, _ = stack_stage_params(stages)
    fn = pipelined_fn(stages[0], n_stages=4, num_microbatches=4)
    out["seq.out"] = fn(stacked, _t(data["seq.x"])).detach().numpy()
    out["seq.block_shape"] = np.asarray(stacked[0].shape)

    stages = _linears(data, "diff.s", 4, 4, 4)
    stacked, _ = stack_stage_params(stages)
    fn = pipelined_fn(stages[0], 4, num_microbatches=2)
    x = _t(data["diff.x"]).requires_grad_()
    (fn(stacked, x) ** 2).sum().backward()
    out["diff.gw"] = stacked[0].grad.numpy()
    out["diff.gb"] = stacked[1].grad.numpy()
    out["diff.gx"] = x.grad.numpy()
    out["diff.stage"] = i

    mesh = _mesh({"pp": 2, "dp": 2})
    stages = _linears(data, "eh.s", 2, 8, 8)
    embed = nn.Embedding(32, 8)
    _load(embed, data, "eh.embed.")
    head = nn.Linear(8, 32)
    _load(head, data, "eh.head.")
    stacked, _ = stack_stage_params(stages)
    fn = pipelined_fn(stages[0], n_stages=2, num_microbatches=4, mesh=mesh,
                      dp_axis="dp", embed_layer=embed, head_layer=head)
    ep, hp = tuple(embed.parameters()), tuple(head.parameters())
    y = fn(stacked, _t(data["eh.ids"]), ep, hp)
    (y ** 2).sum().backward()
    out["eh.out"] = y.detach().numpy()
    out["eh.stage"] = mesh.axis_index("pp")
    out["eh.gw"] = stacked[0].grad.numpy()
    out["eh.gb"] = stacked[1].grad.numpy()
    out["eh.ge"] = ep[0].grad.numpy()
    out["eh.ghw"], out["eh.ghb"] = hp[0].grad.numpy(), hp[1].grad.numpy()
    return out


def _deep_stages(data, prefix, S, depth, D):
    from .. import nn
    stages = []
    for s in range(S):
        seq = nn.Sequential(*[nn.Linear(D, D) for _ in range(depth)])
        if prefix is not None:
            _load(seq, data, f"{prefix}{s}.")
        stages.append(seq)
    return stages


def case_pipeline_memory(data, device) -> Dict[str, object]:
    """``tests/test_pipeline_memory.py`` on {pp: 4} (4 stages of 10
    Linear(64, 64)): the bytes saved for the backward of
    ``mean((out - y)**2)`` with and without remat at M = 8, and with
    remat at M = 16 and 32 (microbatch 64); then remat's loss and
    gradients against the unrematted ones at M = 8, microbatch 4."""
    import paddle_tpu_torch as pt
    from ..parallel import pipeline_train_fn, stack_stage_params
    S, D, depth = 4, 64, 10
    _mesh({"pp": S})
    out = {}
    pt.seed(5)
    stages = _deep_stages(data, None, S, depth, D)
    stacked, _ = stack_stage_params(stages)
    loss_fn = lambda o, yy: ((o - yy) ** 2).mean()  # noqa: E731
    for M, remat in ((8, True), (8, False), (16, True), (32, True)):
        fn = pipeline_train_fn(stages[0], loss_fn, S, M, remat=remat)
        x = torch.zeros(M * 64, D)
        y = torch.zeros(M * 64, D)
        loss, nbytes = saved_bytes(lambda: fn(stacked, x, y),
                                   live=list(stacked) + [x, y])
        loss.backward()
        for p in stacked:
            p.grad = None
        out[f"bytes.M{M}.{'remat' if remat else 'plain'}"] = nbytes
    stages = _deep_stages(data, "num.s", S, depth, D)
    stacked, _ = stack_stage_params(stages)
    x, y = _t(data["num.x"]), _t(data["num.y"])
    for remat in (True, False):
        fn = pipeline_train_fn(stages[0], loss_fn, S, 8, remat=remat)
        loss = fn(stacked, x, y)
        loss.backward()
        tag = "remat" if remat else "plain"
        out[f"num.{tag}.loss"] = float(loss)
        out[f"num.{tag}.g0"] = stacked[0].grad.numpy().copy()
        out[f"num.{tag}.g_last"] = stacked[-1].grad.numpy().copy()
        for p in stacked:
            p.grad = None
    return out


class _GptBlock(torch.nn.Module):
    """``__graft_entry__.dryrun_multichip``'s part E block."""

    def __init__(self, H):
        super().__init__()
        from .. import nn
        self.ln = nn.LayerNorm(H)
        self.attn_qkv = nn.Linear(H, H)
        self.mlp = nn.Linear(H, H)

    def forward(self, h):
        from ..nn import functional as F
        return h + self.mlp(F.gelu(self.attn_qkv(self.ln(h))))


def _gpt_stage_parts(H, V, S):
    """Part E's S blocks, embedding and head (untrained)."""
    from .. import nn
    return [_GptBlock(H) for _ in range(S)], nn.Embedding(V, H), \
        nn.Linear(H, V)


def case_pipeline_gpt(data, device) -> Dict[str, object]:
    """Part E of the dryrun on {pp: 2, dp: 2}: embedding, 2 blocks over
    'pp', head, batch over 'dp', 2 Adam steps (lr 0.01) of the mean
    next-token loss; the losses and the bytes this rank holds (its
    stage block and its optimizer slots, the replicated embedding and
    head apart) against one stage's."""
    from .. import optimizer
    from ..nn import functional as F
    from ..parallel import pipeline_train_fn, stack_stage_params
    H, V = 16, 64
    mesh = _mesh({"pp": 2, "dp": 2})
    blocks, embed, head = _gpt_stage_parts(H, V, 2)
    for s, b in enumerate(blocks):
        _load(b, data, f"gpt.b{s}.")
    _load(embed, data, "gpt.embed.")
    _load(head, data, "gpt.head.")
    one_stage = sum(p.numel() * p.element_size()
                    for p in blocks[0].parameters())
    stacked, _ = stack_stage_params(blocks)
    template = blocks[0]
    del blocks

    def nll(logits, labels):
        return F.cross_entropy(logits.reshape([-1, V]),
                               labels.reshape([-1]))

    fn = pipeline_train_fn(template, nll, 2, 4, mesh=mesh, dp_axis="dp",
                           embed_layer=embed, head_layer=head)
    del template
    ep, hp = list(embed.parameters()), list(head.parameters())
    opt = optimizer.Adam(learning_rate=0.01,
                         parameters=list(stacked) + ep + hp)
    ids, lab = _t(data["gpt.ids"]), _t(data["gpt.lab"])
    losses = []
    for _ in range(2):
        loss = fn(stacked, ids, lab, ep, hp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    block_ids = {id(p) for p in stacked}
    slots = sum(t.numel() * t.element_size()
                for pid, st in (opt._states or {}).items()
                if pid in block_ids for t in st.values()
                if isinstance(t, torch.Tensor) and t.dim() > 0)
    return {"losses": np.asarray(losses),
            "stage_param_bytes": one_stage,
            "block_param_bytes": sum(p.numel() * p.element_size()
                                     for p in stacked),
            "block_slot_bytes": slots,
            "stage": mesh.axis_index("pp")}


def pipeline_gpt_parts(cfg, n_stages, device=None):
    """``testing.models.build_gpt_pipeline``'s blocks cut into
    ``n_stages`` stages of ``layers / n_stages`` blocks each (a
    ``Sequential`` a stage), the embedding and the head.  The blocks are
    made first, in order, then the embedding and the head, so one seed
    gives the same weights however the blocks are cut."""
    from .. import nn
    from .models import build_gpt_pipeline
    stage, embed, head = build_gpt_pipeline(
        cfg["vocab"], cfg["hidden"], cfg["layers"], cfg["heads"],
        cfg["ffn"], cfg["seq"], cfg["dropout"], device=device)
    blocks = list(stage)
    per = len(blocks) // n_stages
    return ([nn.Sequential(*blocks[s * per:(s + 1) * per])
             for s in range(n_stages)], embed, head)


def pipeline_gpt_train(cfg, ids, labels, steps, device=None, seed=67):
    """The pipelined GPT over the installed mesh's 'pp' axis (one stage
    a rank, ``cfg["microbatches"]`` microbatches, remat on), trained
    ``steps`` AdamW steps (lr 1e-4, weight decay 0.01) from the weights
    ``seed`` gives: the losses, one stage's parameter bytes, the bytes
    of this rank's stage block and of its optimizer slots, and (on a
    card) the device memory allocated once the stages are dropped."""
    import paddle_tpu_torch as pt
    from .. import optimizer
    from ..distributed import ensure_mesh
    from ..parallel import pipeline_train_fn, stack_stage_params
    from .models import gpt_pipeline_loss
    S = ensure_mesh().axis_size("pp")
    pt.seed(seed)
    stages, embed, head = pipeline_gpt_parts(cfg, S, device)
    stage_bytes = sum(p.numel() * p.element_size()
                      for p in stages[0].parameters())
    stacked, _ = stack_stage_params(stages)
    fn = pipeline_train_fn(stages[0], gpt_pipeline_loss(cfg["vocab"]), S,
                           cfg["microbatches"], embed_layer=embed,
                           head_layer=head, remat=True)
    del stages
    cuda = stacked[0].is_cuda
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated() if cuda else 0
    ep, hp = list(embed.parameters()), list(head.parameters())
    opt = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                          parameters=list(stacked) + ep + hp)
    losses = []
    for _ in range(steps):
        loss = fn(stacked, ids, labels, ep, hp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    ids_ = {id(p) for p in stacked}
    slots = sum(t.numel() * t.element_size()
                for pid, st in (opt._states or {}).items() if pid in ids_
                for t in st.values()
                if isinstance(t, torch.Tensor) and t.dim() > 0)
    return {"losses": np.asarray(losses), "stage_param_bytes": stage_bytes,
            "block_param_bytes": sum(p.numel() * p.element_size()
                                     for p in stacked),
            "block_slot_bytes": slots,
            "replicated_param_bytes": sum(p.numel() * p.element_size()
                                          for p in ep + hp),
            "allocated_after_drop": allocated}


_P1B_KEYS = ("vocab", "hidden", "layers", "heads", "ffn", "seq",
             "microbatches")


def p1b_inputs(cfg, ids, labels, steps, seed=67):
    """The inputs :func:`case_pipeline_1b` reads."""
    out = {f"p1b.{k}": np.asarray(cfg[k]) for k in _P1B_KEYS}
    out.update({"p1b.ids": ids, "p1b.labels": labels,
                "p1b.steps": np.asarray(steps), "p1b.seed": np.asarray(seed)})
    return out


def case_pipeline_1b(data, device) -> Dict[str, object]:
    """The pipelined GPT over every rank on {pp: world} (the card's
    multi-card leg: the ``1b`` widths, f32, dropout 0; the tests run it
    small): :func:`pipeline_gpt_train`'s result on this rank."""
    cfg = {k: int(data[f"p1b.{k}"]) for k in _P1B_KEYS}
    cfg["dropout"] = 0.0
    _mesh({"pp": torch.distributed.get_world_size()})
    dev = None if device != "cpu" else torch.device("cpu")
    ids, labels = _t(data["p1b.ids"]), _t(data["p1b.labels"])
    if device != "cpu":
        ids, labels = ids.cuda(), labels.cuda()
    return pipeline_gpt_train(cfg, ids, labels, int(data["p1b.steps"]),
                              dev, int(data["p1b.seed"]))


# -------------------------------------------------------------- LocalSGD
def _toy(data, tag, din=4, dout=3):
    from .. import nn
    net = nn.Linear(din, dout)
    _load(net, data, f"{tag}.net.")
    return net, _t(data[f"{tag}.x"]), _t(data[f"{tag}.y"])


def _mse(o, lab):
    from ..nn import functional as F
    return F.mse_loss(o, lab)


def case_localsgd(data, device) -> Dict[str, object]:
    """``tests/test_strategy_toggles.py``'s LocalSGD cases at dp 4: the
    numpy oracle's weights (k 3, begin 2, 7 steps), k = 1 against the
    plain data-parallel step, the replicas apart after one local step,
    adaptive k over 12 steps, fleet's route, the optimizer checkpoint
    round trip."""
    from .. import distributed as dist, optimizer
    from ..distributed.strategy import DistributedStrategy
    from ..parallel import LocalSGDTrainStep, SpmdTrainStep
    _mesh({"dp": 4})
    out = {}

    def strat(adaptive=False, **cfg):
        s = DistributedStrategy()
        if adaptive:
            s.adaptive_localsgd = True
            s.adaptive_localsgd_configs = cfg
        else:
            s.localsgd = True
            s.localsgd_configs = cfg
        return s

    net, x, y = _toy(data, "oracle")
    step = LocalSGDTrainStep(net, _mse, optimizer.SGD(
        0.1, parameters=net.parameters()), strategy=strat(
        k_steps=3, begin_step=2))
    out["oracle.losses"] = [float(step(x, y)) for _ in range(7)]
    step.sync_to_model()
    out["oracle.w"] = net.weight.detach().numpy().copy()
    out["oracle.b"] = net.bias.detach().numpy().copy()

    net, x, y = _toy(data, "k1")
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    step = LocalSGDTrainStep(net, _mse, optimizer.SGD(
        0.05, parameters=net.parameters()), strategy=strat(
        k_steps=1, begin_step=0))
    for _ in range(4):
        step(x, y)
    step.sync_to_model()
    out["k1.local"] = net.weight.detach().numpy().copy()
    net.set_state_dict(init)
    base = SpmdTrainStep(net, _mse, optimizer.SGD(
        0.05, parameters=net.parameters()))
    for _ in range(4):
        base(x, y)
    out["k1.dp"] = net.weight.detach().numpy().copy()

    net, x, y = _toy(data, "diverge")
    step = LocalSGDTrainStep(net, _mse, optimizer.SGD(
        0.1, parameters=net.parameters()), strategy=strat(
        k_steps=4, begin_step=0))
    step(x, y)
    out["diverge.replica"] = step._p_rep[0].numpy().copy()

    net, x, y = _toy(data, "adaptive")
    step = LocalSGDTrainStep(net, _mse, optimizer.SGD(
        0.1, parameters=net.parameters()), strategy=strat(
        True, init_k_steps=4, begin_step=2))
    out["adaptive.flag"] = int(step.adaptive)
    ks, losses = [], []
    for _ in range(12):
        losses.append(float(step(x, y)))
        ks.append(step.k_steps)
    out["adaptive.ks"], out["adaptive.losses"] = ks, losses

    net, x, y = _toy(data, "fleet")
    f = dist.Fleet()
    s = DistributedStrategy()
    s.localsgd = True
    f.init(strategy=s)
    f.distributed_optimizer(optimizer.SGD(0.1, parameters=net.parameters()))
    step = f.get_train_step(net, _mse)
    out["fleet.kind"] = type(step).__name__
    out["fleet.losses"] = [float(step(x, y)) for _ in range(2)]

    net, x, y = _toy(data, "ckpt")
    opt = optimizer.SGD(0.1, parameters=net.parameters())
    step = LocalSGDTrainStep(net, _mse, opt, strategy=strat(
        k_steps=2, begin_step=0))
    for _ in range(3):
        step(x, y)
    sd = opt.state_dict()
    out["ckpt.sd_step"] = sd["step"]
    step.sync_to_model()
    w3 = net.weight.detach().clone()
    for _ in range(2):
        step(x, y)
    with torch.no_grad():
        net.weight.copy_(w3)
    opt.set_state_dict(sd)
    out["ckpt.dropped"] = int(step._p_rep is None)
    out["ckpt.loss"] = float(step(x, y))
    out["ckpt.aux_step"] = int(step._aux["step"])
    return out


# ------------------------------------------------- the row-sharded table
def case_sharded_embedding(data, device) -> Dict[str, object]:
    """``tests/test_sparse.py``'s SPMD parity at dp 4: ShardedEmbedding
    (64 x 8 over 'dp') and Linear(8, 4) under SpmdTrainStep (Adam 0.05,
    2 steps) against a dense-embedding TrainStep on the whole batch;
    the rank's untouched rows unchanged bit for bit."""
    from .. import nn, optimizer
    from ..jit import TrainStep
    from ..nn import functional as F
    from ..parallel import ShardedEmbedding, SpmdTrainStep
    mesh = _mesh({"dp": 4})
    r = mesh.axis_index("dp")

    class Net(nn.Layer):
        def __init__(self, emb):
            super().__init__()
            self.emb = emb
            self.fc = nn.Linear(8, 4)

        def forward(self, ids):
            return self.fc(self.emb(ids).mean(axis=1))

    full = data["emb.weight"]
    net = Net(ShardedEmbedding(64, 8, axis="dp"))
    rows = slice(r * 16, (r + 1) * 16)
    with torch.no_grad():
        net.emb.weight.copy_(_t(full[rows]))
    _load(net.fc, data, "emb.fc.")
    w0 = net.emb.weight.detach().clone()
    ids, y = _t(data["emb.ids"]), _t(data["emb.y"])
    loss_fn = lambda o, lab: F.cross_entropy(o, lab)  # noqa: E731
    step = SpmdTrainStep(net, loss_fn, optimizer.Adam(
        0.05, parameters=net.parameters()), mesh=mesh)
    out = {"spmd.losses": [float(step(ids, y)) for _ in range(2)],
           "rows_before": w0.numpy(),
           "rows_after": net.emb.weight.detach().numpy().copy(),
           "rank": r, "global_shape": np.asarray(
               net.emb.weight.global_shape)}
    dense = Net(nn.Embedding(64, 8))
    with torch.no_grad():
        dense.emb.weight.copy_(_t(full))
    _load(dense.fc, data, "emb.fc.")
    local = TrainStep(dense, loss_fn, optimizer.Adam(
        0.05, parameters=dense.parameters()))
    out["local.losses"] = [float(local(ids, y)) for _ in range(2)]
    return out


# ----------------------------------------------------- strategy toggles
def case_toggles(data, device) -> Dict[str, object]:
    """At dp 4: ``strategy.recompute`` on SpmdTrainStep against the plain
    step (3 SGD steps), and ``gradient_merge`` (k 2, 80 SGD steps)."""
    from .. import optimizer
    from ..distributed.strategy import DistributedStrategy
    from ..parallel import SpmdTrainStep
    _mesh({"dp": 4})
    out = {}
    net, x, y = _toy(data, "rc")
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    s = DistributedStrategy()
    s.recompute = True
    step = SpmdTrainStep(net, _mse, optimizer.SGD(
        0.1, parameters=net.parameters()), strategy=s)
    out["rc.flag"] = int(step._recompute)
    out["rc.losses"] = [float(step(x, y)) for _ in range(3)]
    net.set_state_dict(init)
    base = SpmdTrainStep(net, _mse, optimizer.SGD(
        0.1, parameters=net.parameters()))
    out["rc.base"] = [float(base(x, y)) for _ in range(3)]

    net, x, y = _toy(data, "gm", din=4, dout=2)
    s = DistributedStrategy()
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 2}
    step = SpmdTrainStep(net, _mse, optimizer.SGD(
        0.05, parameters=net.parameters()), strategy=s)
    out["gm.accumulate"] = step.accumulate_steps
    out["gm.losses"] = [float(step(x, y)) for _ in range(80)]
    return out


# ------------------------------------------------ the hybrid {dp, mp} step
def case_hybrid(data, device) -> Dict[str, object]:
    """The hybrid {dp: 2, mp: 2} static Executor: comm_smoke's GPT-tiny
    with every 2-D weight cut over 'mp' (fp32, int8 auto and none; 3
    steps), the overlap matrix row (an mp-cut fc weight; the overlap
    flip is one rebuild named new_sharding) and the fleet fc program
    (no cut) running on the mesh."""
    import paddle_tpu_torch as paddle
    from .. import distributed as dist
    from ..observability import explain_compiles
    from . import sharding_cases as sc
    shape = {"dp": 2, "mp": 2}
    w = [data[f"w{i}"] for i in range(int(data["n_weights"]))]
    cs = [data[f"c{i}"] for i in range(int(data["n_constants"]))]
    feed = {"ids": data["ids"], "labels": data["labels"]}
    out = {}
    for tag, kw in (("fp32", dict(dtype="fp32")),
                    ("int8_auto", dict(dtype="int8")),
                    ("int8_none", dict(dtype="int8", overlap="none"))):
        res = sc.train_comm(w, feed, steps=3, constants=cs, mesh_shape=shape,
                            mp_shard=True, **kw)
        for k, v in res.items():
            out[f"{tag}.{k}"] = v
    fc_feed = {"x": data["fc_x"], "y": data["fc_y"]}
    gc = {"dtype": "int8", "scatter_threshold_KB": 0.01, "block_size": 64,
          "overlap": "auto"}
    paddle.enable_static()
    try:
        dist.init_mesh(shape)
        main, loss = sc._fc_program(gc)
        dist.init_mesh(shape)
        wname = next(p.name for p in main.parameters() if len(p.shape) == 2)
        main._sharding_rules = [(wname, ("mp", None)), (r".*", ())]
        exe = paddle.static.Executor()
        out["matrix.l0"] = float(exe.run(main, feed=fc_feed,
                                         fetch_list=[loss])[0])
        out["matrix.compiles0"] = exe.compile_count
        out["matrix.resting_shape"] = np.asarray(
            main.parameters()[0].shape)
        strat2 = dist.DistributedStrategy()
        strat2.grad_comm = dict(gc, overlap="ring")
        main._optimizer[0]._dist_strategy = strat2
        out["matrix.l1"] = float(exe.run(main, feed=fc_feed,
                                         fetch_list=[loss])[0])
        out["matrix.compiles1"] = exe.compile_count
        recs = [r for r in explain_compiles("executor")["records"]
                if r["identity"] == main._serial]
        out["matrix.cause"] = recs[-1]["cause"]
        exe.close()
        paddle.static.reset_default_programs()

        main, loss = sc._fc_program({"dtype": "int8"})
        dist.init_mesh(shape)
        exe = paddle.static.Executor()
        out["lint.l0"] = float(exe.run(main, feed=fc_feed,
                                       fetch_list=[loss])[0])
        out["lint.compiles"] = exe.compile_count
        exe.close()
    finally:
        paddle.disable_static()
        paddle.static.reset_default_programs()
    return out


def case_hybrid_dropout(data, device) -> Dict[str, object]:
    """The hybrid {dp: 2, mp: 2} Executor with dropout: fc(8 -> 16),
    dropout 0.5, fc(16 -> 1), the first weight cut over 'mp' on dim 1,
    Adam, 3 runs; the parameters afterwards (full values) and the
    losses.  Dropout draws fold in the dp index only, so the two mp
    ranks of a dp group draw the same masks and the replicated
    parameters stay equal on every rank.  Then the refusal of a
    global-norm clip over an mp-cut weight."""
    import paddle_tpu_torch as paddle
    from .. import distributed as dist, optimizer
    import paddle_tpu_torch.nn.functional as F
    shape = {"dp": 2, "mp": 2}
    paddle.enable_static()
    try:
        dist.init_mesh(shape)
        paddle.seed(13)
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            x = paddle.static.data("x", [None, 8], "float32")
            y = paddle.static.data("y", [None, 1], "float32")
            h = F.dropout(paddle.static.nn.fc(x, 16), p=0.5)
            loss = F.mse_loss(paddle.static.nn.fc(h, 1), y)
            s = dist.DistributedStrategy()
            s.grad_comm = {"dtype": "fp32"}
            dist.fleet.init(is_collective=True, strategy=s)
            dist.fleet.distributed_optimizer(
                optimizer.Adam(learning_rate=1e-2)).minimize(loss)
        dist.init_mesh(shape)
        first = main.parameters()[0]
        main._sharding_rules = [(first.name, (None, "mp")), (r".*", ())]
        exe = paddle.static.Executor()
        feed = {"x": data["fc_x"], "y": data["fc_y"]}
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                  for _ in range(3)]
        resting = tuple(main.parameters()[0].shape)
        exe.sync_params(main)
        params = np.concatenate([p.detach().cpu().numpy().ravel()
                                 for p in main.parameters()])
        exe.close()
        # a global-norm clip over an mp-cut chunk would take the norm of
        # the chunk: refused, as for ZeRO-3 rows
        paddle.static.reset_default_programs()
        clipped = paddle.static.Program()
        with paddle.static.program_guard(clipped):
            x = paddle.static.data("x", [None, 8], "float32")
            y = paddle.static.data("y", [None, 1], "float32")
            loss = F.mse_loss(paddle.static.nn.fc(x, 1), y)
            dist.fleet.distributed_optimizer(optimizer.Adam(
                learning_rate=1e-2,
                grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
            ).minimize(loss)
        dist.init_mesh(shape)
        w = clipped.parameters()[0]
        clipped._sharding_rules = [(w.name, ("mp", None)), (r".*", ())]
        exe = paddle.static.Executor()
        try:
            exe.run(clipped, feed=feed, fetch_list=[loss])
            refusal = ""
        except NotImplementedError as e:
            refusal = str(e)
        exe.close()
    finally:
        paddle.disable_static()
        paddle.static.reset_default_programs()
    return {"losses": np.asarray(losses), "params": params,
            "resting_shape": np.asarray(resting), "clip_refusal": refusal}


def case_static_pp(data, device) -> Dict[str, object]:
    """The fc program through fleet without grad_comm on {dp: 2, pp: 2}:
    the 'pp' ranks hold replicas of the computation, each dp group its
    slice of the batch; 3 runs' losses from paddle_tpu's weights."""
    import paddle_tpu_torch as paddle
    from .. import distributed as dist
    from . import sharding_cases as sc
    shape = {"dp": 2, "pp": 2}
    paddle.enable_static()
    try:
        dist.init_mesh(shape)
        main, loss = sc._fc_program(None)
        dist.init_mesh(shape)
        sc._fc_weights(main, data, "fcpp")
        exe = paddle.static.Executor()
        feed = {"x": data["fc_x"], "y": data["fc_y"]}
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                  for _ in range(3)]
        exe.close()
    finally:
        paddle.disable_static()
        paddle.static.reset_default_programs()
    return {"losses": np.asarray(losses)}


CASES = {"pipeline": case_pipeline, "pipeline_memory": case_pipeline_memory,
         "pipeline_gpt": case_pipeline_gpt, "pipeline_1b": case_pipeline_1b,
         "localsgd": case_localsgd,
         "sharded_embedding": case_sharded_embedding,
         "toggles": case_toggles, "hybrid": case_hybrid,
         "hybrid_dropout": case_hybrid_dropout, "static_pp": case_static_pp}


def run(outdir: str, cases, device: str = "cpu"):
    """A rank's entry: join the job, run ``cases`` (names of
    :data:`CASES`), save the results to ``rank<r>.npz``."""
    from .. import distributed as dist
    from ..core import placement
    if device == "cpu":
        torch.set_num_threads(1)    # the ranks share the host's cores
    placement.set_default(torch.device(device) if device == "cpu"
                          else None)
    dist.init_parallel_env(device=device)
    r = torch.distributed.get_rank()
    data = dict(np.load(os.path.join(outdir, "inputs.npz")))
    res = {}
    for name in cases:
        import paddle_tpu_torch as pt
        pt.seed(0)
        for k, v in CASES[name](data, device).items():
            res[f"{name}/{k}"] = np.asarray(v)
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
