"""A weight hot swap on the card: a small BERT saved with ``jit.save``
serves behind the ``InferenceEngine``; a ``WeightWatcher`` loads,
prewarms (K1f once a layer a bucket) and commits the next version; the
old predictor is released, the answers are the new version's, and no
variant is added.  Needs a CUDA device (``pytest -m cuda``); imports no
JAX."""
import gc
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import framework_io, inference, jit, serving
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.jit.save_load import SUFFIX_MODEL, SUFFIX_PARAMS
from paddle_tpu_torch.ops.cuda import support
from paddle_tpu_torch.serving import hotswap
from paddle_tpu_torch.testing.models import build_model
from paddle_tpu_torch.utils import checkpoint

BERT = dict(vocab=1000, hidden=128, layers=2, heads=2, ffn=256, seq=64)
TOL = 2e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.fixture
def on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = placement.default()
    paddle.set_device("gpu")
    try:
        yield tmp_path
    finally:
        placement.set_default(prev)


@pytest.mark.cuda
def test_swap_on_the_card_releases_the_old_predictor(on_card):
    paddle.seed(3)
    model = build_model(**BERT, dropout=0.0, device="cuda")
    model.eval()
    v1 = str(on_card / "v1")
    jit.save(model, v1, input_spec=[jit.InputSpec([None, BERT["seq"]],
                                                  "int64")])
    # version 2: every weight halved, the same program
    v2 = str(on_card / "v2")
    with open(v1 + SUFFIX_PARAMS, "rb") as f:
        state = framework_io.loads(f.read(), device="cpu")
    framework_io.save({k: v * 0.5 if v.is_floating_point() else v
                       for k, v in state.items()}, v2 + SUFFIX_PARAMS)
    with open(v1 + SUFFIX_MODEL, "rb") as f, \
            open(v2 + SUFFIX_MODEL, "wb") as g:
        g.write(f.read())
    ids = np.random.RandomState(0).randint(0, BERT["vocab"],
                                           (3, BERT["seq"]))
    want2 = np.asarray(inference.create_predictor(
        inference.Config(v2)).run([ids])[0])
    eng = serving.InferenceEngine(
        inference.create_predictor(inference.Config(v1)),
        max_batch_size=4, batch_timeout_ms=1.0)
    try:
        eng.warmup()
        want1 = eng.infer_sync([ids], timeout=120)[0]
        gc.collect()
        torch.cuda.synchronize()
        rest = torch.cuda.memory_allocated()
        store = checkpoint.SnapshotStore(os.path.join(str(on_card), "s"))
        w = hotswap.WeightWatcher(store, engine=eng)
        hotswap.publish_weights(store, 2, artifact_prefix=v2)
        support.reset_launch_counts()
        assert w.check_once() == 2
        # the prewarm ran every bucket once: one K1f a layer each
        assert dict(support.launch_counts) == {
            "flash_attention_fwd": BERT["layers"] * len(eng.buckets)}
        got = eng.infer_sync([ids], timeout=120)[0]
        assert _rel(got, want2) <= TOL
        assert _rel(got, want1) > 100 * TOL
        st = eng.stats()
        assert st["recompiles_after_warmup"] == 0
        assert st["weights_version"] == 2
        gc.collect()
        torch.cuda.synchronize()
        # the replaced predictor's weights are gone from the card
        assert abs(torch.cuda.memory_allocated() - rest) < (1 << 20)
    finally:
        eng.close()
