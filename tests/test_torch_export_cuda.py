"""Saved programs on the card: an artifact exported on the CPU (the
plain versions under the custom ops) launches the hand kernels when the
Predictor serves it from the GPU; a CUDA tensor staged with
``share_external_data`` is used without a copy.  Needs a CUDA device
(``pytest -m cuda``); imports no JAX."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import inference, jit, static
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.ops.cuda import support
from paddle_tpu_torch.testing.models import build_bert_static, build_model

BERT = dict(vocab=1000, hidden=128, layers=2, heads=2, ffn=256, seq=64)


def _rel(a, b):
    a, b = torch.Tensor.float(a), torch.Tensor.float(b)
    return float(torch.max(torch.abs(a - b))
                 / torch.clamp_min(torch.max(torch.abs(b)), 1))


@pytest.fixture
def saved_on_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = placement.default()
    paddle.set_device("cpu")
    try:
        yield tmp_path
    finally:
        placement.set_default(prev)


def _gpu_predictor(prefix):
    cfg = inference.Config(prefix)
    cfg.enable_use_gpu()
    return inference.create_predictor(cfg)


@pytest.mark.cuda
def test_a_cpu_saved_bert_launches_flash_on_the_card(saved_on_cpu):
    model = build_model(**BERT, dropout=0.0, device="cpu")
    model.eval()
    prefix = str(saved_on_cpu / "bert")
    jit.save(model, prefix, input_spec=[
        jit.InputSpec([None, BERT["seq"]], "int64")])
    pred = _gpu_predictor(prefix)
    ids = np.random.RandomState(0).randint(0, BERT["vocab"],
                                           (3, BERT["seq"]))
    support.reset_launch_counts()
    out, = pred.run([ids])
    torch.cuda.synchronize()
    assert out.device.type == "cuda"
    assert dict(support.launch_counts) == {
        "flash_attention_fwd": BERT["layers"]}
    with torch.no_grad():
        want = model(torch.from_numpy(ids))
    assert _rel(out.cpu(), want) <= 2e-5


@pytest.mark.cuda
def test_a_cpu_saved_static_bert_launches_k2f_on_the_card(saved_on_cpu):
    main, _, feeds = build_bert_static(**BERT, batch=8, device="cpu")
    logits = [n for n in main.nodes if n.op_name == "linear"][-1].out_vars[0]
    prefix = str(saved_on_cpu / "static")
    static.save_inference_model(prefix, [main.feed_vars["ids"]], [logits],
                                program=main)
    cpu_cfg = inference.Config(prefix)
    cpu_cfg.disable_gpu()
    ids = feeds(np.random.RandomState(1))["ids"]
    want, = inference.create_predictor(cpu_cfg).run([ids])
    pred = _gpu_predictor(prefix)
    support.reset_launch_counts()
    out, = pred.run([ids[:5]])              # padded to the batch of 8
    torch.cuda.synchronize()
    assert dict(support.launch_counts) == {
        "fused_epilogue_fwd": 3 * BERT["layers"],
        "flash_attention_fwd": BERT["layers"]}
    assert tuple(out.shape) == (5, BERT["seq"], BERT["vocab"])
    assert _rel(out.cpu(), want[:5]) <= 2e-5


@pytest.mark.cuda
def test_share_external_data_takes_a_card_tensor_without_a_copy(
        saved_on_cpu):
    net = paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.ReLU(),
                               paddle.nn.Linear(8, 2))
    prefix = str(saved_on_cpu / "mlp")
    jit.save(net, prefix, input_spec=[jit.InputSpec([None, 4])])
    pred = _gpu_predictor(prefix)
    x = torch.randn(4, 4, device="cuda")
    pred.get_input_handle("x0").share_external_data(x)
    assert pred._on_device(x, torch.float32).data_ptr() == x.data_ptr()
    out, = pred.run()
    assert out.device.type == "cuda"
    with torch.no_grad():
        want = net(x.cpu())
    np.testing.assert_allclose(
        pred.get_output_handle("out0").copy_to_cpu(), want.numpy(),
        rtol=1e-5, atol=1e-6)
