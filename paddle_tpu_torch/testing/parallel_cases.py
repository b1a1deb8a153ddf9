"""Multi-rank cases of the parallel layers, run inside ranks started by
:func:`~..distributed.launch.spawn` (the tests on the CPU over gloo, and
the multi-card phase of ``chip_smoke.py`` over NCCL).

:func:`run` is the rank's entry: it joins the job, runs the named cases
on the inputs the caller saved (``inputs.npz``), and saves what each case
returns to ``rank<r>.npz`` in ``outdir``; the caller compares.  Each case
installs the mesh it needs (every rank installs the same meshes in the
same order, as ``torch.distributed.new_group`` requires).  A rank
imports ``torch`` and this package only.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

__all__ = ["run", "CASES", "exit_on_rank"]


def _t(a, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().cpu().numpy()


# ------------------------------------------------------------- collectives
def case_collectives(data, device) -> Dict[str, np.ndarray]:
    """The paddle collective API over {"dp": 2, "mp": 2}."""
    from ..distributed import collective as C
    from ..distributed.mesh import init_mesh
    mesh = init_mesh({"dp": 2, "mp": 2})
    r = torch.distributed.get_rank()
    out = {}
    x = torch.full((4, 3), float(r + 1), device=device)
    out["all_reduce_world"] = _np(C.all_reduce(x.clone()))
    out["all_reduce_mp_max"] = _np(C.all_reduce(x.clone(), C.ReduceOp.MAX,
                                                "mp"))
    out["all_reduce_dp_avg"] = _np(C.all_reduce(x.clone(), C.ReduceOp.AVG,
                                                "dp"))
    parts = []
    out["all_gather_mp"] = _np(C.all_gather(parts, x[:1] * 1, "mp"))
    out["all_gather_parts"] = np.asarray(len(parts))
    out["broadcast_dp"] = _np(C.broadcast(x.clone(), 1, "dp"))
    seq = torch.arange(8.0, device=device).reshape(4, 2) * (r + 1)
    out["reduce_scatter_mp"] = _np(C.reduce_scatter(seq, group="mp"))
    out["scatter_mp"] = _np(C.scatter(seq, src=1, group="mp"))
    rows = torch.stack([torch.full((2,), 10.0 * r + k, device=device)
                        for k in range(2)])
    out["alltoall_mp"] = _np(C.alltoall(rows, group="mp"))
    out["shift_world"] = _np(C.shift(x[0, :1] * 1, 1))
    out["permute_dp"] = _np(C.collective_permute(x[0, :1] * 1, [(0, 1)],
                                                 "dp"))
    if mesh.axis_index("mp") == 0:
        C.send(x[0, :1] * 7, 1, "mp")
        out["recv"] = np.zeros(1, np.float32)
    else:
        out["recv"] = _np(C.recv(torch.zeros(1, device=device), 0, "mp"))
    out["coords"] = np.asarray([mesh.axis_index("dp"),
                                mesh.axis_index("mp")])
    # the differentiable forms: each backward is the conjugate
    y = torch.arange(4.0, device=device).requires_grad_()
    g = torch.autograd.grad((C.ppermute(y * (r + 1), [(0, 1), (1, 0)],
                                        "mp") * torch.arange(
        4.0, device=device)).sum(), y)[0]
    out["ppermute_grad"] = _np(g)
    z = torch.ones(4, device=device).requires_grad_()
    gz = torch.autograd.grad(C.copy_to_group(z, "mp").sum() * (r + 1), z)[0]
    out["copy_to_group_grad"] = _np(gz)
    s = torch.arange(4.0, device=device).requires_grad_()
    sl = C.scatter_to_group(s, "mp", dim=0)
    gs = torch.autograd.grad((sl * (sl + 1)).sum(), s)[0]
    out["scatter_to_group_grad"] = _np(gs)
    return out


# ----------------------------------------------------- collective matmuls
def case_collective_matmul(data, device, meshes=((2, {"dp": 2, "mp": 2}),
                                                 (4, {"mp": 4}))
                           ) -> Dict[str, np.ndarray]:
    """Column- and row-parallel fused matmuls at mp 2 and 4, ring and
    not, with their oracles: gather-then-chunk-matmul for the column form
    and the ascending-order sum of every rank's partial for the row
    form."""
    from ..distributed.collective import _gather, axis_group
    from ..distributed.grad_comm import gather_param
    from ..distributed.mesh import init_mesh
    from ..ops.collective_matmul import (_chunk_mm, all_gather_matmul,
                                         matmul_reduce_scatter)
    out = {}
    for n, shape in meshes:
        init_mesh(shape)
        g = axis_group("mp")
        i = g.rank
        for tag in ("f32", "bf16", "ungated"):
            dt = torch.bfloat16 if tag == "bf16" else torch.float32
            x = _t(data[f"x_{tag}"], device, dt)
            w = _t(data[f"w_{tag}"], device, dt)
            nc = w.shape[1] // n
            ws = w[:, i * nc:(i + 1) * nc].contiguous()
            key = f"n{n}_{tag}"
            col = all_gather_matmul(x, ws, "mp", n, ring=True)
            out[f"col_ring_{key}"] = _np(col)
            out[f"col_fused_{key}"] = _np(all_gather_matmul(
                x, ws, "mp", n, ring=False))
            out[f"col_oracle_{key}"] = _np(_chunk_mm(
                x, gather_param(ws, g, n, dim=1)))
            kr = x.shape[1] // n
            xr = x[:, i * kr:(i + 1) * kr]
            wr = w[i * kr:(i + 1) * kr].contiguous()
            rows = matmul_reduce_scatter(xr, wr, "mp", n, ring=True)
            out[f"row_ring_{key}"] = _np(rows)
            out[f"row_fused_{key}"] = _np(matmul_reduce_scatter(
                xr, wr, "mp", n, ring=False))
            parts = _gather(_chunk_mm(xr, wr)[None], g)
            total = parts[0]
            for k in range(1, n):
                total = total + parts[k]
            m = x.shape[0] // n
            out[f"row_oracle_{key}"] = _np(total[i * m:(i + 1) * m])
        try:
            matmul_reduce_scatter(xr[:5], wr, "mp", n)
            out[f"row_error_n{n}"] = np.asarray("")
        except ValueError as e:
            out[f"row_error_n{n}"] = np.asarray(str(e))
    return out


# -------------------------------------------------------- ring attention
def case_ring_attention(data, device, meshes=((2, {"dp": 2, "sp": 2}),
                                              (4, {"sp": 4}))
                        ) -> Dict[str, np.ndarray]:
    """Ring attention at sp 2 and 4, causal and not, on the flash body
    (D 32) and the plain body (D 8): the output and the gradients of
    sum(out * w) w.r.t. q, k and v (full length, replicated)."""
    from ..distributed.mesh import init_mesh
    from ..parallel.ring_attention import ring_attention
    out = {}
    for n, shape in meshes:
        mesh = init_mesh(shape)
        for d in (32, 8):
            q, k, v, w = (_t(data[f"{a}_d{d}"], device)
                          for a in ("q", "k", "v", "w"))
            for causal in (True, False):
                qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                o = ring_attention(qg, kg, vg, is_causal=causal, mesh=mesh)
                grads = torch.autograd.grad((o * w).sum(), (qg, kg, vg))
                key = f"n{n}_d{d}_{'causal' if causal else 'full'}"
                out[f"out_{key}"] = _np(o)
                for name, gr in zip(("dq", "dk", "dv"), grads):
                    out[f"{name}_{key}"] = _np(gr)
    return out


# ------------------------------------------------------------- TP layers
def case_tp_layers(data, device):
    """VocabParallelEmbedding (vocab not divisible by mp), column- and
    row-parallel linears and the vocab-parallel cross entropy at mp 2,
    from full weights: the output, the loss and each shard's gradient."""
    from ..distributed.mesh import init_mesh
    from ..framework_io import (shard_state_from_paddle_tpu,
                                state_dict_from_paddle_tpu)
    from ..parallel import (ColumnParallelLinear, ParallelCrossEntropy,
                            RowParallelLinear, VocabParallelEmbedding)
    init_mesh({"dp": 2, "mp": 2})
    vocab, hidden, ffn = (int(data[k]) for k in ("vocab", "hidden", "ffn"))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = VocabParallelEmbedding(vocab, hidden, device=device)
            self.col = ColumnParallelLinear(hidden, ffn, device=device)
            self.row = RowParallelLinear(ffn, hidden, device=device)
            self.head = ColumnParallelLinear(hidden, int(data["classes"]),
                                             gather_output=False,
                                             device=device)
            self.ce = ParallelCrossEntropy()

        def forward(self, ids, labels):
            h = self.row(torch.nn.functional.gelu(self.col(self.emb(ids))))
            return h, self.ce(self.head(h), labels)

    net = Net()
    full = {k[len("tp."):]: data[k] for k in data.files
            if k.startswith("tp.")}
    net.load_state_dict(state_dict_from_paddle_tpu(
        shard_state_from_paddle_tpu(full, net), device, model=net))
    from ..optimizer.clip import _global_norm
    h, loss = net(_t(data["ids"], device), _t(data["labels"], device))
    params = list(net.parameters())
    grads = torch.autograd.grad(loss + (h * _t(data["hw"], device)).sum(),
                                params)
    out = {"h": _np(h), "loss": _np(loss),
           "grad_norm": _np(_global_norm(params, list(grads)))}
    for (name, p), g in zip(net.named_parameters(), grads):
        out[f"grad.{name}"] = _np(g)
        out[f"shape.{name}"] = np.asarray(p.shape)
    return out


# --------------------------------------------------------- data parallel
def case_data_parallel(data, device):
    """{"dp": 4}: DataParallel's eager backward and SpmdTrainStep on a
    small MLP, each rank on its quarter of the batch, against the same
    model on the whole batch in this process (no collectives)."""
    import copy
    from .. import jit, optimizer
    from ..distributed.mesh import init_mesh, set_mesh
    from ..parallel import DataParallel, SpmdTrainStep
    x, y = _t(data["dx"], device), _t(data["dy"], device)
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 2)).to(device)
    loss_fn = torch.nn.functional.mse_loss
    whole = copy.deepcopy(net)
    set_mesh(None)                         # the local oracle: one rank
    loss_fn(whole(x), y).backward()
    ostep = jit.TrainStep(copy.deepcopy(net), loss_fn, optimizer.Adam(
        learning_rate=1e-2))
    oracle = [float(ostep(x, y)) for _ in range(3)]
    mesh = init_mesh({"dp": 4})
    r, per = mesh.axis_index("dp"), x.shape[0] // 4
    dp = DataParallel(copy.deepcopy(net))
    loss_fn(dp(x[r * per:(r + 1) * per]), y[r * per:(r + 1) * per]).backward()
    err = max((a.grad - b.grad).abs().max().item() for a, b in
              zip(dp.parameters(), whole.parameters()))
    step = SpmdTrainStep(copy.deepcopy(net), loss_fn,
                         optimizer.Adam(learning_rate=1e-2), mesh=mesh)
    return {"grad_err": np.asarray(err), "oracle": np.asarray(oracle),
            "losses": np.asarray([float(step(x, y)) for _ in range(3)])}


def case_scaler_overflow(data, device):
    """SpmdTrainStep with a GradScaler when one rank alone overflows.
    {"dp": 4}: a small MLP whose first step has an inf in rank 0's
    quarter of the labels, then a finite step, against one TrainStep on
    the whole batch in this process.  {"dp": 2, "mp": 2}: a column- and
    row-parallel MLP whose first step makes rank 0's column shard's
    gradient inf (a hook), then a finite step.  Every rank must skip the
    first step and apply the second, with one loss scale."""
    import copy
    from .. import amp, jit, optimizer
    from ..core import rng
    from ..distributed.mesh import init_mesh, set_mesh
    from ..parallel import (ColumnParallelLinear, RowParallelLinear,
                            SpmdTrainStep)
    x, y = _t(data["dx"], device), _t(data["dy"], device)
    bad = y.clone()
    bad[0, 0] = float("inf")               # in rank 0's quarter only
    loss_fn = torch.nn.functional.mse_loss
    scaler = lambda: amp.GradScaler(init_loss_scaling=1024.0,  # noqa: E731
                                    incr_every_n_steps=1)
    flat = lambda m: torch.cat([p.detach().reshape(-1)  # noqa: E731
                                for p in m.parameters()]).cpu().numpy()
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 2)).to(device)
    out = {"dp.init": flat(net)}
    set_mesh(None)                         # the local oracle: one rank
    whole = copy.deepcopy(net)
    ostep = jit.TrainStep(whole, loss_fn, optimizer.Adam(learning_rate=1e-2),
                          scaler=scaler())
    ostep(x, bad)
    ostep(x, y)
    out["dp.oracle"], out["dp.oracle_scale"] = flat(whole), np.asarray(
        ostep.loss_scale)
    mesh = init_mesh({"dp": 4})
    step = SpmdTrainStep(net, loss_fn, optimizer.Adam(learning_rate=1e-2),
                         mesh=mesh, scaler=scaler())
    for i, labels in enumerate((bad, y)):
        step(x, labels)
        out[f"dp.params{i}"] = flat(net)
        out[f"dp.scale{i}"] = np.asarray(step.loss_scale)

    init_mesh({"dp": 2, "mp": 2})
    rng.seed(5)

    class TP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.col = ColumnParallelLinear(8, 16, device=device)
            self.row = RowParallelLinear(16, 2, device=device)

        def forward(self, t):
            return self.row(torch.tanh(self.col(t)))

    tp = TP()
    out["mp.init"] = flat(tp)
    blow = [torch.distributed.get_rank() == 0]
    tp.col.weight.register_hook(
        lambda g: g * float("inf") if blow[0] else g)
    step = SpmdTrainStep(tp, loss_fn, optimizer.Adam(learning_rate=1e-2),
                         scaler=scaler())
    for i in range(2):
        step(x, y)
        blow[0] = False
        out[f"mp.params{i}"] = flat(tp)
        out[f"mp.scale{i}"] = np.asarray(step.loss_scale)
    return out


def case_batch_norm_dp(data, device):
    """{"dp": 4}: a conv + BatchNorm2D net, each rank on its quarter of
    the batch, against the same net on the whole batch in this process.
    Saves the batch norm's input and output shards of one forward (the
    test holds their concatenation to paddle_tpu's ``F.batch_norm``), the
    gradients of the mean loss averaged over 'dp', and the losses,
    parameters and running buffers of 2 ``SpmdTrainStep``s beside 2
    ``TrainStep``s on the whole batch."""
    from .. import jit, nn, optimizer
    from ..distributed.collective import axis_group
    from ..distributed.mesh import init_mesh, set_mesh
    from ..nn import functional as F
    from ..nn.functional.norm import stats_over
    from ..parallel import SpmdTrainStep
    from ..parallel.data_parallel import allreduce_gradients
    x, y = _t(data["bx"], device), _t(data["by"], device)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 4, 3, padding=1, device=device)
            self.bn = nn.BatchNorm2D(4, device=device)
            self.fc = nn.Linear(4, 2, device=device)

        def forward(self, t):
            h = F.relu(self.bn(self.conv(t)))
            return self.fc(h.mean([2, 3]))

    def net():
        m = Net()
        with torch.no_grad():
            for k, v in m.state_dict().items():
                v.copy_(_t(data[f"bn.{k}"], device))
        return m

    def state(m):
        return {k: _np(v) for k, v in m.state_dict().items()}

    loss_fn = F.mse_loss
    out = {}
    set_mesh(None)                         # the local oracle: one rank
    whole = net()
    loss_fn(whole(x), y).backward()
    out.update({f"oracle_grad.{k}": _np(p.grad)
                for k, p in whole.named_parameters()})
    ostep_net = net()
    ostep = jit.TrainStep(ostep_net, loss_fn, optimizer.SGD(0.1))
    out["oracle_losses"] = np.asarray([float(ostep(x, y))
                                       for _ in range(2)])
    out.update({f"oracle_state.{k}": v for k, v in state(ostep_net).items()})

    mesh = init_mesh({"dp": 4})
    dp = axis_group("dp", mesh)
    r, per = dp.rank, x.shape[0] // 4
    xs, ys = x[r * per:(r + 1) * per], y[r * per:(r + 1) * per]
    m = net()
    with stats_over(dp):
        h = m.conv(xs)
        out["bn_in"], out["bn_out"] = _np(h), _np(m.bn(h))
        out.update({f"fwd_state.{k}": _np(v) for k, v in
                    (("_mean", m.bn._mean), ("_variance", m.bn._variance))})
        m = net()
        loss_fn(m(xs), ys).backward()
    grads = allreduce_gradients(
        [p.grad for _, p in m.named_parameters()], dp)
    out.update({f"grad.{k}": _np(g) for (k, _), g in
                zip(m.named_parameters(), grads)})
    snet = net()
    step = SpmdTrainStep(snet, loss_fn, optimizer.SGD(0.1), mesh=mesh)
    out["losses"] = np.asarray([float(step(x, y)) for _ in range(2)])
    out.update({f"state.{k}": v for k, v in state(snet).items()})
    return out


def case_dp_sparse_embedding(data, device):
    """{"dp": 4}: ``nn.Embedding(sparse=True)`` + ``Linear`` under
    DataParallel, each rank on its quarter of the batch, against the same
    net on the whole batch in this process.  Saves, for each side, the
    merged sparse embedding gradient (rows, values) and the Linear
    weight's gradient of the first backward, and the parameters after 2
    steps of ``Adam(lazy_mode=True)``."""
    from .. import nn, optimizer
    from ..core.selected_rows import sparse_grad
    from ..core.tensor import raw_grad
    from ..distributed.mesh import init_mesh, set_mesh
    from ..nn import functional as F
    from ..parallel import DataParallel
    ids, y = _t(data["se_ids"], device), _t(data["se_y"], device)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(40, 4, sparse=True, device=device)
            self.fc = nn.Linear(4, 3, device=device)
            with torch.no_grad():
                for k, v in self.state_dict().items():
                    v.copy_(_t(data["se." + k], device))

        def forward(self, t):
            return self.fc(self.emb(t).mean(1))

    def run(net, lo, hi, tag):
        layer = getattr(net, "_layers", net)
        opt = optimizer.Adam(learning_rate=0.01, lazy_mode=True,
                             parameters=net.parameters())
        for i in range(2):
            F.mse_loss(net(ids[lo:hi]), y[lo:hi]).backward()
            if i == 0:
                sr = sparse_grad(raw_grad(layer.emb.weight)).merge()
                out[f"{tag}.rows"], out[f"{tag}.values"] = (
                    sr.rows.cpu().numpy(), _np(sr.values))
                out[f"{tag}.fc_grad"] = _np(layer.fc.weight.grad)
            opt.step()
            opt.clear_grad()
        out.update({f"{tag}.param.{k}": _np(v)
                    for k, v in layer.named_parameters()})

    out = {}
    set_mesh(None)                         # the local oracle: one rank
    run(Net(), 0, ids.shape[0], "oracle")
    mesh = init_mesh({"dp": 4})
    r, per = mesh.axis_index("dp"), ids.shape[0] // 4
    run(DataParallel(Net()), r * per, (r + 1) * per, "dp")
    return out


# ----------------------------------------------------------- hybrid GPT
def gpt_run(cfg, state, batch, steps, mesh_shape, device, dtype=None,
            lr=2e-4, seed=2024):
    """``build_gpt_hybrid`` on ``mesh_shape``, from the full weights
    ``state`` or, when it is None, from the weights ``seed`` draws (the
    layers draw whole weights and cut them, so every mesh gets the same);
    ``steps`` SpmdTrainSteps of AdamW(lr, wd 0.01) + global-norm clip
    1.0 (O2 when ``dtype`` is bf16).  Returns the losses and the
    model."""
    from .. import amp, optimizer
    from ..core import rng
    from ..distributed.mesh import init_mesh
    from ..framework_io import (shard_state_from_paddle_tpu,
                                state_dict_from_paddle_tpu)
    from ..parallel import SpmdTrainStep
    from .models import build_gpt_hybrid, gpt_loss
    mesh = init_mesh(mesh_shape)
    rng.seed(seed)
    model = build_gpt_hybrid(cfg["vocab"], cfg["hidden"], cfg["layers"],
                             cfg["heads"], cfg["ffn"], cfg["seq"],
                             cfg["dropout"], device=device)
    if state is not None:
        model.load_state_dict(state_dict_from_paddle_tpu(
            shard_state_from_paddle_tpu(state, model, mesh), device,
            model=model))
    bf16 = dtype == torch.bfloat16
    opt = optimizer.AdamW(learning_rate=lr, parameters=model.parameters(),
                          weight_decay=0.01,
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                          multi_precision=bf16)
    if bf16:
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = SpmdTrainStep(model, gpt_loss(model), opt, mesh=mesh)
    x, y = (_t(a, device) for a in batch)
    losses = [float(step(x, y)) for _ in range(steps)]
    return losses, model


def case_gpt(data, device):
    """5 SpmdTrainSteps of the small hybrid GPT on {"mp": 2, "sp": 2}:
    the losses and every parameter shard after the last step."""
    cfg = {k: int(data[f"cfg.{k}"]) for k in
           ("vocab", "hidden", "layers", "heads", "ffn", "seq")}
    cfg["dropout"] = 0.0
    state = {k[len("gpt."):]: data[k] for k in data.files
             if k.startswith("gpt.")}
    losses, model = gpt_run(cfg, state, (data["gx"], data["gy"]),
                            int(data["steps"]), {"mp": 2, "sp": 2}, device)
    out = {"losses": np.asarray(losses)}
    for name, p in model.named_parameters():
        out[f"param.{name}"] = _np(p)
    return out


def case_dp_dropout(data, device):
    """The small hybrid GPT at dropout 0.5 on {"dp": 2, "mp": 2}, fed a
    batch whose two dp halves are identical: each rank's own loss (before
    the 'dp' average) over 2 SpmdTrainSteps.  Equal losses across dp
    would mean equal masks."""
    from .. import optimizer
    from ..core import rng
    from ..distributed.mesh import init_mesh
    from ..parallel import SpmdTrainStep
    from .models import build_gpt_hybrid, gpt_loss
    cfg = {k: int(data[f"cfg.{k}"]) for k in
           ("vocab", "hidden", "layers", "heads", "ffn", "seq")}
    mesh = init_mesh({"dp": 2, "mp": 2})
    rng.seed(2024)
    model = build_gpt_hybrid(cfg["vocab"], cfg["hidden"], cfg["layers"],
                             cfg["heads"], cfg["ffn"], cfg["seq"], 0.5,
                             device=device)
    local = []

    class Step(SpmdTrainStep):
        def _reduce_loss(self, loss):
            local.append(float(loss))
            return super()._reduce_loss(loss)

    step = Step(model, gpt_loss(model), optimizer.AdamW(
        learning_rate=2e-4, parameters=model.parameters()), mesh=mesh)
    half = len(data["gx"]) // 2
    x, y = (_t(np.concatenate([data[k][:half]] * 2), device)
            for k in ("gx", "gy"))
    for _ in range(2):
        step(x, y)
    return {"local_losses": np.asarray(local)}


def case_gpt_multicard(data, device):
    """The multi-card phase of ``chip_smoke.py``: the hybrid GPT at the
    mesh and widths ``data`` names, from seeded weights, for ``steps``
    SpmdTrainSteps in f32: the losses."""
    cfg = {k: int(data[f"cfg.{k}"]) for k in
           ("vocab", "hidden", "layers", "heads", "ffn", "seq")}
    cfg["dropout"] = 0.0
    shape = dict(zip(str(data["mesh_axes"]).split(","),
                     (int(n) for n in data["mesh_sizes"])))
    losses, _ = gpt_run(cfg, None, (data["gx"], data["gy"]),
                        int(data["steps"]), shape, device)
    return {"losses": np.asarray(losses)}


def case_two_card(data, device):
    """Two ranks: ring attention over {"sp": 2}, the collective matmuls
    over {"mp": 2}."""
    out = case_ring_attention(data, device, ((2, {"sp": 2}),))
    out.update(case_collective_matmul(data, device, ((2, {"mp": 2}),)))
    return out


CASES = {"collectives": case_collectives, "two_card": case_two_card,
         "data_parallel": case_data_parallel,
         "gpt_multicard": case_gpt_multicard,
         "collective_matmul": case_collective_matmul,
         "ring_attention": case_ring_attention,
         "tp_layers": case_tp_layers, "gpt": case_gpt,
         "dp_dropout": case_dp_dropout,
         "scaler_overflow": case_scaler_overflow,
         "batch_norm_dp": case_batch_norm_dp,
         "dp_sparse_embedding": case_dp_sparse_embedding}


def exit_on_rank(rank: int, code: int, wait_s: float):
    """A rank entry that exits with ``code`` on rank ``rank`` and sleeps
    ``wait_s`` seconds on the others (the launcher's failure test)."""
    import time
    if int(os.environ["RANK"]) == rank:
        raise SystemExit(code)
    time.sleep(wait_s)


def run(outdir: str, cases, device: str = "cpu"):
    """A rank's entry (spawned): join the job, run ``cases`` in order on
    ``outdir/inputs.npz``, save ``outdir/rank<r>.npz``."""
    import torch.distributed as dist
    from ..distributed.env import init_parallel_env
    torch.set_num_threads(1)
    init_parallel_env(device=device)
    dev = torch.device("cpu") if device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    data = np.load(os.path.join(outdir, "inputs.npz"))
    results = {}
    try:
        for name in cases:
            for k, v in CASES[name](data, dev).items():
                results[f"{name}/{k}"] = v
        np.savez(os.path.join(outdir, f"rank{dist.get_rank()}.npz"),
                 **results)
    finally:
        dist.destroy_process_group()
