"""The gradient-communication stage (``paddle_tpu_torch.distributed.
grad_comm``) held to paddle_tpu's.

The planning half is pure and runs here against the JAX package: the
block-scaled int8 codec bitwise, the buckets, the algorithm choice, the
ring model's wire bytes, the production order, the FSDP layout and the
shared cause strings are paddle_tpu's exactly.

The running half needs ranks: one gloo world of 4 CPU ranks per module
(``testing.sharding_cases``) runs

- ``tools/comm_smoke.py``'s flows on its GPT-tiny (fleet + the static
  Executor, 4 steps a configuration, paddle_tpu's weights): fp32, int8
  under ``overlap`` auto / none / ring, ZeRO-3 int8 (auto, none), bf16,
  and no grad_comm (with and without ZeRO-3).  comm_smoke's gates: int8
  wire bytes under 0.35x fp32's, measured ``comm.wire_bytes`` equal to
  the cost model's ``predicted_wire_bytes`` in every overlap mode (and
  per axis, and the ZeRO-3 gather leg), int8 losses within 2e-3 of
  fp32's after every step; and the port's losses within 1e-5 (fp32) and
  5e-5 (int8) of paddle_tpu's on the same mesh shape, with the same
  predicted bytes;
- ``tests/test_distributed.py``'s fc-program cases (losses against
  paddle_tpu's, the residual carry, ZeRO-3 fp32 bitwise against the
  gathered path, the sum loss refused, the overlap flip's rebuild and
  residual restart);
- ``reduce_gradients`` on each rank's rows: every overlap path bitwise
  at fp32, int8 within one quantization step, error feedback
  telescoping on the gathered and the FSDP routes.

The overlap timing gate of comm_smoke (1.15x) is not asserted: the
ranks share this host's cores.  The hybrid {dp, mp} legs run in
``tests/test_torch_pipeline_parallel.py``'s world.
"""
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu.distributed.mesh import init_mesh as jinit_mesh
from paddle_tpu_torch.distributed import grad_comm as tgc
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.testing import sharding_cases

DP = 4


def _jspec(dtype="int8", block=64, ef=True, thresh=0.0, fuse=32.0,
           overlap="auto"):
    return jgc.CommSpec(dtype, block, ef, thresh, fuse, "grad_comm",
                        overlap)


def _tspec(dtype="int8", block=64, ef=True, thresh=0.0, fuse=32.0,
           overlap="auto"):
    return tgc.CommSpec(dtype, block, ef, thresh, fuse, "grad_comm",
                        overlap)


# ---------------------------------------------------------------- pure
@pytest.mark.parametrize("block", [32, 64, 256])
def test_int8_blocks_are_paddle_tpus_bitwise(block):
    """Quantize and dequantize agree bit for bit with paddle_tpu's
    (absmax/127, scale 1 for a zero block, round half to even, clip to
    ±127), and the round trip is within half a step of each block's
    scale."""
    rng = np.random.RandomState(block)
    x = (rng.standard_normal(1000) * 7.0).astype(np.float32)
    x[:block] = 0.0                              # one all-zero block
    x[block:block + 4] = [0.5, -0.5, 1.5, 2.5]   # ties
    jq, js = jgc.quantize_int8_blocks(jnp.asarray(x), block)
    tq, ts = tgc.quantize_int8_blocks(torch.from_numpy(x), block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tgc.dequantize_int8_blocks(tq, ts, 1000).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jgc.dequantize_int8_blocks(jq, js, 1000)))
    bound = np.repeat(ts.numpy().ravel(), block)[:1000] * 0.5 + 1e-7
    assert np.all(np.abs(back - x) <= bound)


def test_bucket_assembly_is_paddle_tpus_and_bitwise():
    """Greedy buckets in production order within the fuse budget, and
    flatten/unflatten (plain and the FSDP shard-major layout) bitwise,
    equal to paddle_tpu's."""
    shapes = [(3, 5), (7,), (2, 2, 2), (11,), (4,)]
    for mb in (256 * 4 / (1 << 20), 12 * 4 / (1 << 20)):
        assert tgc.build_buckets(shapes, mb) == jgc.build_buckets(shapes,
                                                                  mb)
    tiny = tgc.build_buckets(shapes, 12 * 4 / (1 << 20))
    assert [i for b, _ in tiny for i in b] == [4, 3, 2, 1, 0]
    rng = np.random.RandomState(1)
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tg = [torch.from_numpy(g) for g in grads]
    jg = [jnp.asarray(g) for g in grads]
    plan = tgc.plan_reduction(shapes, dp=1, cfg=_tspec())
    jplan = jgc.plan_reduction(shapes, dp=1, cfg=_jspec())
    for b, jb in zip(plan.buckets, jplan.buckets):
        flat = tgc.flatten_bucket(tg, b)
        np.testing.assert_array_equal(flat.numpy(),
                                      np.asarray(jgc.flatten_bucket(jg, jb)))
        back = dict(tgc.unflatten_bucket(flat, b, tg))
        for i in b.indices:
            np.testing.assert_array_equal(back[i].numpy(), grads[i])
    fshapes = [(8, 3), (4,), (12, 2)]
    fg = [rng.standard_normal(s).astype(np.float32) for s in fshapes]
    for dtype in ("fp32", "int8"):
        plan = tgc.plan_reduction(fshapes, dp=DP, cfg=_tspec(dtype, 4),
                                  fsdp=(0, 1, 2))
        jplan = jgc.plan_reduction(fshapes, dp=DP, cfg=_jspec(dtype, 4),
                                   fsdp=(0, 1, 2))
        for b, jb in zip(plan.buckets, jplan.buckets):
            assert tgc.bucket_flat_numel(b, DP, 4) == \
                jgc.bucket_flat_numel(jb, DP, 4)
            flat = tgc.flatten_bucket_fsdp(
                [torch.from_numpy(g) for g in fg], b, DP, 4)
            np.testing.assert_array_equal(flat.numpy(), np.asarray(
                jgc.flatten_bucket_fsdp([jnp.asarray(g) for g in fg], jb,
                                        DP, 4)))
            row = flat.reshape(DP, -1)[1]
            got = dict(tgc.unflatten_bucket_fsdp(
                row, b, DP, [torch.from_numpy(g) for g in fg]))
            for i in b.indices:
                per = fshapes[i][0] // DP
                np.testing.assert_array_equal(got[i].numpy(),
                                              fg[i][per:2 * per])


PLAN_CASES = [
    dict(dp=8, dtype="int8", block=64, thresh=2176 / 1024.0),
    dict(dp=8, dtype="int8", block=64, thresh=2177 / 1024.0),
    dict(dp=4, dtype="fp32", block=256, thresh=4.0),
    dict(dp=4, dtype="bf16", block=256, thresh=0.0),
    dict(dp=2, dtype="int8", block=32, thresh=0.01, fsdp=(0, 2)),
    dict(dp=1, dtype="int8", block=64, thresh=0.0),
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_reduction_plans_are_paddle_tpus(case):
    """Buckets, algorithms (scatter at or above the threshold, psum
    below, int8's psum on bf16 wire, rscatter for FSDP), collectives,
    issue points and the ring model's wire bytes, per bucket and in
    total, equal paddle_tpu's exactly."""
    shapes = [(2048,), (33, 7), (130,), (9,), (64, 16)]
    case = dict(case)
    dp, fsdp = case.pop("dp"), case.pop("fsdp", ())
    order = [4, 2, 0, 3, 1]
    kw = dict(dp=dp, order=order, fsdp=fsdp)
    tp = tgc.plan_reduction(shapes, cfg=_tspec(fuse=0.01, **case), **kw)
    jp = jgc.plan_reduction(shapes, cfg=_jspec(fuse=0.01, **case), **kw)
    td, jd = tp.to_dict(), jp.to_dict()
    td.pop("overlap_path"), jd.pop("overlap_path")
    assert td == jd
    assert tp.algo_counts() == jp.algo_counts()
    if dp > 1 and case["dtype"] == "int8" and not fsdp:
        assert tp.wire_bytes_per_step < 0.35 * tp.fp32_wire_bytes_per_step \
            or tp.buckets[0].algorithm == "psum"


@pytest.fixture
def cpu():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import placement
    prev = placement.default()
    pt.set_device("cpu")
    yield pt
    placement.set_default(prev)


def test_production_order_and_gathers_are_paddle_tpus(cpu):
    """On GPT-tiny recorded by both packages (and on a skip branch
    recorded before the trunk), the backward production order, the
    ZeRO-3 layout and the gather schedule are paddle_tpu's."""
    pt = cpu
    from tools.shard_smoke import build_gpt_tiny
    paddle.enable_static()
    pt.enable_static()
    try:
        jmain, jloss, _ = build_gpt_tiny()
        tmain, tloss = sharding_cases.build_gpt_tiny()
        jo = jgc.production_order(jmain, jmain.parameters(), jloss)
        to = tgc.production_order(tmain, tmain.parameters(), tloss)
        assert to == jo
        shapes = [tuple(p.shape) for p in tmain.parameters()]
        kinds = [("fsdp", 0) if s[0] % DP == 0 else ("rep", None)
                 for s in shapes]
        assert tgc.plan_gathers(shapes, kinds, {"dp": DP}, order=to) \
            == jgc.plan_gathers(shapes, kinds, {"dp": DP}, order=jo)
        for pkg, gcx in ((paddle, jgc), (pt, tgc)):
            main = pkg.static.Program()
            with pkg.static.program_guard(main):
                x = pkg.static.data("x", [None, 8], "float32")
                y = pkg.static.data("y", [None, 1], "float32")
                skip = pkg.static.nn.fc(x, 1)
                h = pkg.static.nn.fc(x, 16)
                out = pkg.static.nn.fc(h, 1)
                loss = pkg.nn.functional.mse_loss(out + skip, y)
            order = gcx.production_order(main, main.parameters(), loss)
            pos = {i: k for k, i in enumerate(order)}
            assert max(pos[0], pos[1]) < min(pos[2], pos[3])
            assert max(pos[4], pos[5]) < min(pos[2], pos[3])
            if pkg is paddle:
                jorder = order
            else:
                assert order == jorder
    finally:
        paddle.disable_static()
        paddle.static.reset_default_programs()
        pt.disable_static()


def test_cause_strings_and_status_are_paddle_tpus():
    """The incompatibility and fetch messages, the axis renderer and
    ``classify_spec`` are paddle_tpu's text for text."""
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as TP
    for cfg_kw in (dict(), dict(dtype="bf16")):
        t, j = _tspec(**cfg_kw), _jspec(**cfg_kw)
        for mesh in ({"dp": 4}, {"dp": 4, "mp": 2}, {"dp": 2, "pp": 2}):
            assert tgc.incompatibility(t, mesh) == \
                jgc.incompatibility(j, mesh)
            assert tgc.incompatibility(t, mesh, ["w"]) == \
                jgc.incompatibility(j, mesh, ["w"])
        for spec in ((), ("dp",), (None, "dp"), ("mp",), (None, "mp"),
                     ("dp", "mp"), (("dp", "mp"),), ("pp",)):
            mesh = {"dp": 4, "mp": 2, "pp": 2}
            assert tgc.classify_spec(TP(*spec), mesh) == \
                jgc.classify_spec(JP(*spec), mesh)
            assert tgc.incompatibility(t, {"dp": 4, "mp": 2},
                                       [("w", TP(*spec))], hybrid=True) \
                == jgc.incompatibility(j, {"dp": 4, "mp": 2},
                                       [("w", JP(*spec))], hybrid=True)
    alias = _tspec("bf16")
    alias = tgc.CommSpec("bf16", 256, False, 32.0, 32.0, "fp16_allreduce")
    jalias = jgc.CommSpec("bf16", 256, False, 32.0, 32.0, "fp16_allreduce")
    assert tgc.source_label(alias) == jgc.source_label(jalias)
    assert tgc.fetch_rule_message("f", (8, 2), (3,)) == \
        jgc.fetch_rule_message("f", (8, 2), (3,))
    assert tgc.sum_fetch_message("loss", "l") == \
        jgc.sum_fetch_message("loss", "l")
    assert tgc.format_mesh_axes({"dp": 4, "mp": 2, "pp": 1}) == \
        jgc.format_mesh_axes({"dp": 4, "mp": 2, "pp": 1})


def test_overlap_path_from_the_process_groups_backend_kept_difference():
    """Kept difference: paddle_tpu resolves ``overlap="auto"`` from the
    backend and its XLA latency-hiding state (the fused form on CPU, the
    ring on a TPU or GPU without the scheduler); the port takes no
    backend, since gloo and NCCL both run each bucket's collectives
    asynchronously: ``auto`` is the fused ``'xla'`` path on every
    backend.  ``none`` and ``ring`` resolve as asked on both
    packages."""
    for ov in ("none", "ring"):
        assert tgc.resolve_overlap_path(_tspec(overlap=ov)) == ov
        assert jgc.resolve_overlap_path(_jspec(overlap=ov), "gpu") == ov
    auto = _tspec()
    assert tgc.resolve_overlap_path(auto) == "xla"
    assert tgc.plan_reduction([(64,)], dp=4, cfg=auto).overlap_path == "xla"
    assert jgc.resolve_overlap_path(_jspec(), "cpu") == "xla"
    assert jgc.resolve_overlap_path(_jspec(), "gpu") == "ring"
    assert "falls back to the 'xla'" in tgc.overlap_note(auto)
    assert "on every backend" in tgc.overlap_note(auto)
    fps = {tgc.resolve(_strategy(ov)).fingerprint()
           for ov in ("none", "auto", "ring")}
    assert len(fps) == 3


def _strategy(overlap):
    from paddle_tpu_torch.distributed import DistributedStrategy
    s = DistributedStrategy()
    s.grad_comm = {"dtype": "int8", "overlap": overlap}
    return s


def test_exposed_and_hidden_comm_split():
    """The cost model's link simulation and the perf observatory's
    split: hidden is 0 on the ``'none'`` path, the tail of the last
    bucket is what an overlapping schedule exposes (paddle_tpu's
    numbers)."""
    from paddle_tpu_torch.observability.perf import PerfObservatory
    from paddle_tpu_torch.static.analysis.cost import _comm_seconds
    one = {"enabled": True, "overlap_path": "none",
           "wire_bytes_per_step": 2_000_000,
           "collectives": [{"wire_bytes": 2_000_000, "issue_frac": 1.0}]}
    assert _comm_seconds(one, 0.01, 1e9) == (0.002, 0.002)
    two = {"enabled": True, "overlap_path": "ring",
           "wire_bytes_per_step": 2_000_000,
           "collectives": [{"wire_bytes": 1_000_000, "issue_frac": 0.5},
                           {"wire_bytes": 1_000_000, "issue_frac": 1.0}]}
    total, exposed = _comm_seconds(two, 0.01, 1e9)
    assert total == 0.002 and abs(exposed - 0.001) < 1e-12
    obs = PerfObservatory(sample_every=1, memory=False)
    t0 = time.perf_counter()
    obs.step("executor", "idA", t0, 0.0, t0, 0.0,
             predicted={"predicted_step_s": 1e-3,
                        "predicted_comm_s": 5e-4,
                        "predicted_exposed_comm_s": 5e-4,
                        "comm_overlap": "none"})
    c = obs.report()["identities"][0]["comm"]
    assert c["hidden_ms"] == 0.0 and c["exposed_ms"] == c["comm_ms"]


# ------------------------------------------------------------ the ranks
def _gpt_reference():
    """paddle_tpu's GPT-tiny weights and constants (comm_smoke's seed)."""
    from tools.shard_smoke import build_gpt_tiny
    paddle.enable_static()
    try:
        paddle.seed(7)
        main, _, _ = build_gpt_tiny()
        ws = [np.asarray(p.data) for p in main.parameters()]
        cs = [np.asarray(v) for node in main.nodes
              for tag, v in node.in_specs if tag == "c"]
    finally:
        paddle.disable_static()
        paddle.static.reset_default_programs()
    return ws, cs


def _fc_reference(mode):
    """paddle_tpu's fc program at dp 4: its weights and 5 losses."""
    import paddle_tpu.nn.functional as JF
    from paddle_tpu import distributed as jdist, optimizer as jopt
    paddle.enable_static()
    try:
        jinit_mesh({"dp": DP})
        paddle.seed(7)
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            x = paddle.static.data("x", [None, 8], "float32")
            y = paddle.static.data("y", [None, 1], "float32")
            loss = JF.mse_loss(paddle.static.nn.fc(x, 1), y)
            s = jdist.DistributedStrategy()
            if mode == "int8":
                s.grad_comm = {"dtype": "int8", "scatter_threshold_KB":
                               0.01, "block_size": 64}
            jdist.fleet.init(is_collective=True, strategy=s)
            opt = jdist.fleet.distributed_optimizer(
                jopt.Adam(learning_rate=1e-2))
            opt.minimize(loss)
        jinit_mesh({"dp": DP})
        w = [np.asarray(p.data).copy() for p in main.parameters()]
        exe = paddle.static.Executor()
        feed = _fc_feed()
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                  for _ in range(5)]
        exe.close()
    finally:
        paddle.disable_static()
        paddle.static.reset_default_programs()
    return w, losses


def _fc_feed():
    rng = np.random.RandomState(1)
    xs = rng.standard_normal((64, 8)).astype(np.float32)
    return {"x": xs, "y": (xs @ rng.standard_normal((8, 1))).astype(
        np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("grad_comm")
    ws, cs = _gpt_reference()
    data = {f"w{i}": w for i, w in enumerate(ws)}
    data.update({f"c{i}": c for i, c in enumerate(cs)})
    data.update(n_weights=len(ws), n_constants=len(cs), steps=4)
    data.update(sharding_cases.gpt_feeds())
    jfc = {m: _fc_reference(m) for m in ("none", "int8")}
    data["fc_w"], data["fc_b"] = jfc["none"][0]
    feed = _fc_feed()
    data["fc_x"], data["fc_y"] = feed["x"], feed["y"]
    rng = np.random.RandomState(5)
    shapes = [(33, 7), (130,), (9,)]
    for i, s in enumerate(shapes):
        data[f"red_shape{i}"] = np.asarray(s)
        data[f"red_g{i}"] = (rng.standard_normal((DP,) + s)
                             * 10 ** (i - 1)).astype(np.float32)
    data["ef_g"] = np.random.RandomState(3).standard_normal(
        (DP, 96)).astype(np.float32)
    np.savez(out / "inputs.npz", **data)
    spawn(sharding_cases.run, (str(out), ["comm", "fc", "reduce"]),
          nprocs=DP, init_method=f"file://{out}/store", timeout=300)
    res = [dict(np.load(out / f"rank{i}.npz")) for i in range(DP)]
    return data, jfc, res


def _get(res, key, rank=0):
    return res[rank][key]


@pytest.fixture(scope="module")
def jax_comm():
    """comm_smoke's own runs of paddle_tpu on the same mesh shape."""
    from tools.comm_smoke import _train
    out = {}
    for tag, kw in (("fp32", dict(dtype="fp32")),
                    ("int8_auto", dict(dtype="int8")),
                    ("z3_auto", dict(dtype="int8", zero3=True))):
        out[tag] = _train(steps=4, mesh_shape={"dp": DP}, **kw)
    return out


def test_comm_smoke_gates_on_gloo_ranks(ranks):
    """comm_smoke's gates at dp 4: int8 wire < 0.35x fp32's; measured
    == predicted in every overlap mode, per axis and for the ZeRO-3
    gather leg; int8 losses within 2e-3 of fp32's after every step; one
    build a configuration; several buckets, each with its algorithm;
    the ranks agree bitwise."""
    _, _, res = ranks
    g = lambda k: _get(res, "comm/" + k)  # noqa: E731
    fp32 = g("fp32.losses")
    assert g("int8_auto.wire_bytes_per_step") < \
        0.35 * g("fp32.wire_bytes_per_step")
    for tag in ("fp32", "int8_auto", "int8_none", "int8_ring", "z3_auto",
                "z3_none", "bf16"):
        assert g(f"{tag}.compiles") == 1
        assert g(f"{tag}.wire_bytes_per_step") == \
            g(f"{tag}.predicted_wire_bytes"), tag
        assert g(f"{tag}.axis_dp_wire_bytes") == \
            g(f"{tag}.predicted_axis_dp"), tag
        assert g(f"{tag}.gather_wire_bytes_per_step") == \
            g(f"{tag}.predicted_gather_wire_bytes"), tag
        assert g(f"{tag}.buckets") >= 2
        if tag != "fp32":
            np.testing.assert_allclose(g(f"{tag}.losses"), fp32, atol=2e-3)
        for r in range(1, DP):
            np.testing.assert_array_equal(_get(res, f"comm/{tag}.params",
                                               r), g(f"{tag}.params"))
    assert json.loads(str(g("int8_auto.algorithms"))) == ["scatter"]
    assert json.loads(str(g("z3_auto.algorithms"))) == ["rscatter"]
    assert g("z3_auto.gather_collectives_per_step") > 0
    assert g("int8_auto.residual_buckets") == g("int8_auto.buckets")
    assert json.loads(str(g("int8_auto.overlap_path"))) == "xla"
    assert json.loads(str(g("int8_none.overlap_path"))) == "none"
    # the barriered path hides nothing (the observatory's split)
    assert g("int8_none.hidden_ms") == 0.0
    # without grad_comm the plan runs an unstatted fp32 reduction with
    # the fp32 numerics: ZeRO-3 is bitwise the replicated step
    assert g("plain.wire_bytes_per_step") == 0
    np.testing.assert_array_equal(g("plain.losses"), g("plain_z3.losses"))
    np.testing.assert_array_equal(g("plain.params"), g("plain_z3.params"))
    np.testing.assert_array_equal(g("plain.losses"), fp32)
    # the ring and the fused route sum in one order: bitwise
    np.testing.assert_array_equal(g("int8_ring.losses"),
                                  g("int8_auto.losses"))


def test_comm_flows_match_paddle_tpu_on_the_same_mesh(ranks, jax_comm):
    """The port against comm_smoke's own paddle_tpu runs at dp 4: the
    same predicted wire bytes (total, per axis, gathers), losses within
    1e-5 (fp32) and 5e-5 (int8, ZeRO-3 int8) of paddle_tpu's."""
    _, _, res = ranks
    for tag, tol in (("fp32", 1e-5), ("int8_auto", 5e-5),
                     ("z3_auto", 5e-5)):
        j = jax_comm[tag]
        g = lambda k: _get(res, f"comm/{tag}.{k}")  # noqa: E731
        assert g("predicted_wire_bytes") == j["predicted_wire_bytes"]
        assert g("wire_bytes_per_step") == j["wire_bytes_per_step"]
        assert g("predicted_axis_dp") == \
            j["predicted_axis_wire_bytes"].get("dp", 0)
        assert g("predicted_gather_wire_bytes") == \
            j["predicted_gather_wire_bytes"]
        assert g("buckets") == j["buckets"]
        assert json.loads(str(g("algorithms"))) == j["algorithms"]
        np.testing.assert_allclose(g("losses"), j["losses"], rtol=0,
                                   atol=tol)


def test_zero3_params_rest_at_the_per_shard_price(ranks):
    """Between runs a rank holds what ``analyze(sharding=plan)`` prices
    per shard (``memory_per_shard``), params and optimizer slots alike:
    under ZeRO-3 at dp 4 a quarter of each dp-sharded param (GPT-tiny's
    every param shards), without ZeRO every param whole."""
    _, _, res = ranks
    for tag in ("z3_auto", "z3_none", "plain_z3", "fp32", "plain"):
        for r in range(DP):
            g = lambda k: _get(res, f"comm/{tag}.{k}", r)  # noqa: E731
            assert g("resident_param_bytes") == \
                g("predicted_param_bytes"), (tag, r)
            assert g("resident_slot_bytes") == \
                g("predicted_slot_bytes"), (tag, r)
    full = _get(res, "comm/fp32.resident_param_bytes")
    for tag in ("z3_auto", "z3_none", "plain_z3"):
        assert DP * _get(res, f"comm/{tag}.resident_param_bytes") == full


def test_fc_program_under_grad_comm_matches_paddle_tpu(ranks):
    """``test_grad_comm_executor_parity_wire_stats_and_prediction``: the
    int8 stage and the plan without grad_comm give paddle_tpu's losses
    (atol 1e-5; int8 against no grad_comm within 2e-3), one build each,
    measured wire == 5x predicted, collectives likewise, no wire without
    grad_comm, one residual bucket of 9 elements per rank."""
    _, jfc, res = ranks
    g = lambda k: _get(res, "fc/" + k)  # noqa: E731
    for mode in ("none", "int8"):
        np.testing.assert_allclose(g(f"{mode}.losses"), jfc[mode][1],
                                   rtol=0, atol=1e-5)
        assert g(f"{mode}.compiles") == 1
    np.testing.assert_allclose(g("none.losses"), g("int8.losses"),
                               atol=2e-3)
    assert g("none.wire") == 0
    assert g("int8.wire") == 5 * g("int8.pred_wire") > 0
    assert g("int8.colls") == 5 * g("int8.pred_colls")
    comm = json.loads(str(g("int8.comm")))
    assert comm["enabled"] and comm["dtype"] == "int8"
    for c in comm["collectives"]:
        assert c["algorithm"] in ("psum", "scatter")
    assert json.loads(str(g("int8.ef_shapes"))) == [[9]]


def test_fsdp_fp32_is_bitwise_the_gathered_path(ranks):
    """``test_grad_comm_fsdp_fp32_bitwise_parity_vs_gathered``: ZeRO-3
    at fp32 wire (the weight dp-sharded, its gradient reduce-scattered,
    its rows updated and gathered) trains bitwise as the gathered dp
    path, losses and parameters."""
    _, _, res = ranks
    g = lambda k: _get(res, "fc/" + k)  # noqa: E731
    assert json.loads(str(g("z1.specs")))[0] == ["dp"]
    assert json.loads(str(g("z0.specs")))[0] == []
    np.testing.assert_array_equal(g("z0.losses"), g("z1.losses"))
    np.testing.assert_array_equal(g("z0.params"), g("z1.params"))


def test_sum_reduced_loss_is_refused(ranks):
    """``test_grad_comm_rejects_sum_reduced_loss``: paddle_tpu's
    message."""
    _, _, res = ranks
    assert "SUM-reduced" in str(_get(res, "fc/sum_loss"))
    assert str(_get(res, "fc/sum_loss")) == tgc.sum_fetch_message(
        "loss", str(_get(res, "fc/sum_loss")).split("'")[1])


def test_overlap_flip_rebuilds_and_restarts_the_residuals(ranks):
    """``test_grad_comm_overlap_knob_recompile_rezero_and_bucket_stats``:
    the flip is one rebuild named ``new_sharding`` whose record carries
    the new path and the same buckets; the poisoned residual carry is
    dropped (the run equals a fresh 'none' run with its carry zeroed
    after step 1), and a poisoned carry without the flip changes step
    3; the per-bucket and per-algorithm stats are the plan's."""
    _, _, res = ranks
    g = lambda k: _get(res, "fc/flip." + k)  # noqa: E731
    assert g("bucket0") == g("bucket0_pred")
    assert g("scatter") == g("pred")
    assert g("rebuilds") == 1 and g("key_moved") == 1
    assert str(g("cause")) == "new_sharding"
    assert str(g("path")) == "none" and g("buckets_match") == 1
    la, lc, ld = g("la"), g("lc"), g("ld")
    np.testing.assert_array_equal(la, lc)
    assert ld[-1] != lc[-1]


def test_reduce_gradients_paths_and_error_feedback(ranks):
    """On each rank's rows: fp32 is bitwise across the xla, ring and
    none paths and equal to the mean (rtol 1e-6); int8's ring is within
    one quantization step of the fused route; 24 int8 steps with error
    feedback stay within two steps of the true running mean on the
    gathered and the FSDP routes, and without it drift over 3x
    further."""
    data, _, res = ranks
    g = lambda k, r=0: _get(res, "reduce/" + k, r)  # noqa: E731
    grads = [data[f"red_g{i}"] for i in range(3)]
    for i in range(3):
        base = g(f"fp32.xla.{i}")
        for mode in ("ring", "none"):
            np.testing.assert_array_equal(g(f"fp32.{mode}.{i}"), base)
        np.testing.assert_allclose(base, grads[i].mean(0), rtol=1e-6,
                                   atol=1e-6)
        bound = max(float(np.abs(x).max()) for x in grads) / 127.0
        assert np.abs(g(f"int8.ring.{i}") - g(f"int8.xla.{i}")).max() \
            < bound
    ef_g = data["ef_g"]
    one_step = float(np.abs(ef_g).max()) / 127.0
    for route in ("gathered", "fsdp"):
        if route == "gathered":
            true = 24 * ef_g.mean(0)
            ef, plain = g(f"ef.{route}.1"), g(f"ef.{route}.0")
        else:
            assert str(g("ef.fsdp.algo")) == "rscatter"
            true = 24 * ef_g.mean(0)
            ef = np.concatenate([g("ef.fsdp.1", r) for r in range(DP)])
            plain = np.concatenate([g("ef.fsdp.0", r) for r in range(DP)])
        err_ef = np.abs(ef - true).max()
        err_plain = np.abs(plain - true).max()
        assert err_ef < 2 * one_step, (route, err_ef)
        assert err_plain > 3 * err_ef, (route, err_plain, err_ef)
