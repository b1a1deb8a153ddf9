"""The inference engine and the C ABI on the card: a small BERT (D 64,
so the flash gate takes it) saved on the CPU and served from the GPU
through ``InferenceEngine`` (one flash forward a layer for every batch
it dispatches, every answer within the flash tolerance of that request
run alone through the Predictor) and through ``CPredictor`` (one a
layer a run).  Needs a CUDA device (``pytest -m cuda``); imports no
JAX."""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import inference, jit, serving
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.ops.cuda import support
from paddle_tpu_torch.testing.models import build_model

BERT = dict(vocab=1000, hidden=128, layers=2, heads=2, ffn=256, seq=64)
FLASH_TOL = 2e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.fixture
def bert_prefix(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = placement.default()
    paddle.set_device("cpu")
    try:
        paddle.seed(3)
        model = build_model(**BERT, dropout=0.0, device="cpu")
        model.eval()
        prefix = str(tmp_path / "bert")
        jit.save(model, prefix, input_spec=[
            jit.InputSpec([None, BERT["seq"]], "int64")])
    finally:
        placement.set_default(prev)
    return prefix


def _gpu_predictor(prefix):
    cfg = inference.Config(prefix)
    cfg.enable_use_gpu()
    return inference.create_predictor(cfg)


@pytest.mark.cuda
def test_engine_launches_flash_once_a_layer_a_batch(bert_prefix):
    pred = _gpu_predictor(bert_prefix)
    ref = _gpu_predictor(bert_prefix)
    eng = serving.InferenceEngine(pred, max_batch_size=8,
                                  batch_timeout_ms=2.0)
    try:
        eng.warmup()
        rng = np.random.RandomState(0)
        reqs = [rng.randint(0, BERT["vocab"], (int(rng.randint(1, 4)),
                                               BERT["seq"]))
                for _ in range(24)]
        support.reset_launch_counts()
        b0 = eng.stats()["counters"]["batches"]
        outs = [None] * len(reqs)

        def client(c):
            for i in range(c, len(reqs), 4):
                outs[i] = eng.infer_sync([reqs[i]], timeout=120)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batches = eng.stats()["counters"]["batches"] - b0
        counts = dict(support.launch_counts)
        assert counts == {"flash_attention_fwd": BERT["layers"] * batches}
        assert eng.stats()["recompiles_after_warmup"] == 0
        for x, out in zip(reqs, outs):
            want = np.asarray(ref.run([x])[0])
            assert out[0].shape == want.shape
            assert _rel(out[0], want) <= FLASH_TOL
    finally:
        eng.close()


@pytest.mark.cuda
def test_c_abi_on_the_card(bert_prefix, monkeypatch):
    from paddle_tpu_torch.inference.capi import DEVICE_ENV, CPredictor
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    ref = _gpu_predictor(bert_prefix)
    ids = np.random.RandomState(1).randint(0, BERT["vocab"],
                                           (3, BERT["seq"]))
    with CPredictor(bert_prefix) as p:
        support.reset_launch_counts()
        out = p.run([ids.astype(np.float32)])
        assert dict(support.launch_counts) == {
            "flash_attention_fwd": BERT["layers"]}
    want = np.asarray(ref.run([ids])[0])
    assert _rel(out[0], want) <= FLASH_TOL
