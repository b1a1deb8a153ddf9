"""``hapi`` held to paddle_tpu's: ``Model`` (prepare, fit, evaluate,
predict, the batch methods, save and load, both adapters), the callbacks
and ``summary`` (the twins of ``tests/test_hapi_vision_breadth.py``'s
model cases, the hapi cases of ``tests/test_highlevel.py`` and the
checkpoint-callback cases of ``tests/test_fault_tolerance.py``), and the
slice as a whole: a 2-layer BERT fitted by ``paddle.Model`` in each
package from the same weights over the same tokenized batches.

Both packages start from the same numpy weights and read the same
batches in the same order (``shuffle=False``, where the samplers' own
streams would differ).  Tolerances: losses within 1e-5 relative for the
BERT (f32 sums in another order, then AdamW), 1e-4 for the small nets
fitted 24 steps at lr 0.05 (the same drift compounded); parameters and
summaries exactly."""
import importlib.util
import json
import os
import signal

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import hapi as jhapi, io as jio, metric as jmetric
from paddle_tpu import nn as jnn, optimizer as jopt

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import hapi as thapi, io as tio, metric as tmetric
from paddle_tpu_torch import nn as tnn, optimizer as topt
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (jpaddle, jhapi, jio, jnn, jopt, JF, jmetric),
         "torch": (tpaddle, thapi, tio, tnn, topt, TF, tmetric)}


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    yield
    placement.set_default(None)


def _np(t):
    return np.asarray(t.numpy())


def _load(paddle, net, weights):
    net.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    return net


def _weights(net):
    return {k: _np(v).copy() for k, v in net.state_dict().items()}


class _Losses:
    """A callback class per package recording every step's loss."""

    @staticmethod
    def make(hapi, sink):
        class Rec(hapi.Callback):
            def on_train_batch_end(self, step, logs=None):
                sink.append(logs["loss"])
        return Rec()


# -- summary ---------------------------------------------------------------
@pytest.mark.parametrize("side", sorted(SIDES))
def test_model_summary_output_shapes(side, capsys):
    _, hapi, _, nn, _, _, _ = SIDES[side]
    net = nn.Sequential(nn.Conv2D(1, 4, 3, padding=1), nn.ReLU(),
                        nn.Flatten(), nn.Linear(4 * 8 * 8, 10))
    res = hapi.summary(net, input_size=(1, 1, 8, 8))
    out = capsys.readouterr().out
    assert "Output Shape" in out and "[1, 4, 8, 8]" in out
    assert "[1, 10]" in out and "Non-trainable params: 0" in out
    assert res["total_params"] == (4 * 9 + 4) + (4 * 64 * 10 + 10)
    assert res["trainable_params"] == res["total_params"]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_summary_counts_tied_and_root_params(side, capsys):
    paddle, hapi, _, nn, _, _, _ = SIDES[side]

    class Tied(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(10, 4)
            self.fc = nn.Linear(4, 4)
            self.scale = self.create_parameter([4])

        def forward(self, ids):
            return self.fc(self.emb(ids)) * self.scale

    res = hapi.summary(Tied())
    assert res["total_params"] == 10 * 4 + (4 * 4 + 4) + 4
    assert "(Tied)" in capsys.readouterr().out
    assert paddle.summary(nn.Linear(10, 5))["total_params"] == 55


# -- Model -------------------------------------------------------------------
class _TwoInputDs:
    def __init__(self, n=32):
        r = np.random.RandomState(5)
        self.a = r.randn(n, 4).astype(np.float32)
        self.b = r.randn(n, 4).astype(np.float32)
        self.y = (self.a.sum(1) + self.b.sum(1) > 0).astype(np.int64)

    def __len__(self):
        return len(self.a)

    def __getitem__(self, i):
        return self.a[i], self.b[i], self.y[i]


def _two_tower(nn, F):
    class TwoTower(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fa = nn.Linear(4, 8)
            self.fb = nn.Linear(4, 8)
            self.head = nn.Linear(8, 2)

        def forward(self, a, b):
            return self.head(F.relu(self.fa(a)) + F.relu(self.fb(b)))
    return TwoTower()


TOWER = None


def _tower_weights():
    global TOWER
    if TOWER is None:
        r = np.random.RandomState(100)
        TOWER = {f"{n}.{k}": (r.randn(*s) * 0.5).astype(np.float32)
                 for n, ins in (("fa", 4), ("fb", 4), ("head", 8))
                 for k, s in (("weight", (ins, 2 if n == "head" else 8)),
                              ("bias", (2 if n == "head" else 8,)))}
    return TOWER


@pytest.mark.parametrize("jit_compile", [True, False])
def test_multi_input_multi_loss_matches_paddle_tpu(jit_compile):
    """Two declared inputs and a loss returning a list (summed), through
    the TrainStep adapter and the eager one."""
    hist = {}
    for side, (paddle, hapi, io, nn, opt, F, _) in SIDES.items():
        from importlib import import_module
        spec = import_module(paddle.__name__ + ".static").InputSpec
        net = _load(paddle, _two_tower(nn, F), _tower_weights())
        model = hapi.Model(net, inputs=[spec([None, 4], "float32"),
                                        spec([None, 4], "float32")],
                           labels=[spec([None], "int64")])

        def multi_loss(out, y):
            return [F.cross_entropy(out, y), 1e-3 * (out ** 2).mean()]

        model.prepare(opt.Adam(learning_rate=5e-3,
                               parameters=net.parameters()),
                      multi_loss, jit_compile=jit_compile)
        losses = []
        model.fit(_TwoInputDs(), batch_size=8, epochs=3, verbose=0,
                  shuffle=False, callbacks=[_Losses.make(hapi, losses)])
        hist[side] = losses
    np.testing.assert_allclose(hist["torch"], hist["jax"], rtol=1e-4)
    assert hist["torch"][-1] < hist["torch"][0]


def test_eager_adapter_matches_train_step_adapter():
    hist = {}
    for jit_compile in (True, False):
        net = _load(tpaddle, _two_tower(tnn, TF), _tower_weights())
        m = thapi.Model(net, inputs=[object(), object()])
        m.prepare(topt.SGD(learning_rate=0.05, parameters=net.parameters()),
                  lambda out, y: TF.cross_entropy(out, y),
                  jit_compile=jit_compile)
        hist[jit_compile] = m.fit(_TwoInputDs(), batch_size=8, epochs=2,
                                  shuffle=False, verbose=0)["loss"]
    np.testing.assert_allclose(hist[True], hist[False], rtol=1e-5)


def _mlp_data():
    r = np.random.RandomState(5)
    X = r.rand(64, 4).astype(np.float32)
    W = np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
    return X, (X @ W > 0.6).astype(np.int64).reshape(-1)


def _mlp(nn, paddle, seed=7):
    r = np.random.RandomState(seed)
    net = nn.Sequential(nn.Linear(4, 16), nn.ReLU(), nn.Linear(16, 2))
    return _load(paddle, net, {
        "0.weight": r.randn(4, 16).astype(np.float32) * 0.5,
        "0.bias": np.zeros(16, np.float32),
        "2.weight": r.randn(16, 2).astype(np.float32) * 0.5,
        "2.bias": np.zeros(2, np.float32)})


def test_fit_evaluate_predict_save_load_match_paddle_tpu(tmp_path):
    X, Y = _mlp_data()
    got = {}
    for side, (paddle, hapi, io, nn, opt, F, metric) in SIDES.items():
        ds = io.TensorDataset([X, Y])
        net = _mlp(nn, paddle)
        model = paddle.Model(net)
        model.prepare(opt.Adam(0.05, parameters=net.parameters()),
                      nn.CrossEntropyLoss(), metric.Accuracy())
        hist = model.fit(ds, epochs=6, batch_size=16, verbose=0,
                         shuffle=False)
        logs = model.evaluate(ds, batch_size=16, verbose=0)
        preds = model.predict(ds, batch_size=16, stack_outputs=True)
        path = str(tmp_path / side / "ckpt")
        os.makedirs(os.path.dirname(path))
        model.save(path)
        net2 = _mlp(nn, paddle, seed=8)
        m2 = paddle.Model(net2)
        m2.prepare(opt.Adam(0.05, parameters=net2.parameters()),
                   nn.CrossEntropyLoss(), metric.Accuracy())
        m2.load(path)
        assert m2._optimizer.state_dict().keys() == \
            model._optimizer.state_dict().keys()
        got[side] = (hist["loss"], logs, preds[0], _weights(net),
                     _weights(net2), m2.evaluate(ds, batch_size=16,
                                                 verbose=0))
    t, j = got["torch"], got["jax"]
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
    assert t[0][-1] < t[0][0] and t[1]["acc"] > 0.8
    assert abs(t[1]["acc"] - j[1]["acc"]) <= 1 / 64
    np.testing.assert_allclose(t[1]["loss"], j[1]["loss"], rtol=1e-4)
    assert t[2].shape == (64, 2)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-4, atol=1e-4)
    for k in t[3]:
        np.testing.assert_array_equal(t[4][k], t[3][k])
    assert t[5] == t[1]
    # the port loads the file paddle_tpu wrote, and the other way round
    net3 = _mlp(tnn, tpaddle, seed=9)
    thapi.Model(net3).load(str(tmp_path / "jax" / "ckpt"))
    for k, v in _weights(net3).items():
        np.testing.assert_array_equal(v, j[4][k])


def test_batch_methods():
    X, Y = _mlp_data()
    net = _mlp(tnn, tpaddle)
    model = thapi.Model(net)
    model.prepare(topt.SGD(0.1, parameters=net.parameters()),
                  tnn.CrossEntropyLoss())
    loss = model.train_batch([X[:8]], [Y[:8]])
    assert len(loss) == 1 and np.isfinite(loss[0])
    ev, metrics, out = model.eval_batch([X[:8]], [Y[:8]])
    assert len(ev) == 1 and metrics == [] and tuple(out.shape) == (8, 2)
    out = model.predict_batch(X[:4])
    assert tuple(out.shape) == (4, 2) and net.training
    assert len(model.parameters()) == 4


@pytest.mark.parametrize("side", sorted(SIDES))
def test_model_early_stopping(side):
    paddle, hapi, io, nn, opt, _, _ = SIDES[side]
    ds = io.TensorDataset([np.random.RandomState(1).rand(16, 2).astype(
        np.float32), np.zeros(16, np.int64)])
    net = nn.Linear(2, 2)
    model = paddle.Model(net)
    model.prepare(opt.SGD(0.0, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    es = hapi.EarlyStopping(monitor="loss", patience=0, min_delta=1e9)
    model.fit(ds, eval_data=ds, epochs=10, batch_size=8, verbose=0,
              callbacks=[es])
    assert model.stop_training


@pytest.mark.parametrize("side", sorted(SIDES))
def test_reduce_lr_on_plateau_callback(side):
    _, hapi, _, nn, opt, _, _ = SIDES[side]
    net = nn.Linear(4, 1)
    m = hapi.Model(net)
    cb = hapi.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=2,
                                verbose=0)
    cb.set_model(m)
    m._optimizer = opt.SGD(learning_rate=0.1, parameters=net.parameters())
    for loss in [1.0, 0.9, 0.9, 0.9]:
        cb.on_epoch_end(0, {"loss": loss})
    assert abs(m._optimizer.get_lr() - 0.05) < 1e-9


@pytest.mark.parametrize("side", sorted(SIDES))
def test_visualdl_callback_writes_scalars(tmp_path, side):
    hapi = SIDES[side][1]
    cb = hapi.VisualDL(log_dir=str(tmp_path))
    cb.on_train_batch_end(0, {"loss": 1.5})
    cb.on_eval_end({"acc": [0.9]})
    rows = [json.loads(ln) for ln in open(tmp_path / "scalars.jsonl")]
    assert {r["tag"] for r in rows} == {"train/loss", "eval/acc"}


def test_lr_scheduler_callback_steps_the_scheduler():
    X, Y = _mlp_data()
    lrs = {}
    for side, (paddle, hapi, io, nn, opt, _, _) in SIDES.items():
        net = _mlp(nn, paddle)
        sched = opt.lr.StepDecay(learning_rate=0.1, step_size=2, gamma=0.5)
        model = hapi.Model(net)
        model.prepare(opt.SGD(learning_rate=sched,
                              parameters=net.parameters()),
                      nn.CrossEntropyLoss())
        model.fit(io.TensorDataset([X, Y]), batch_size=16, epochs=1,
                  verbose=0, shuffle=False, log_freq=1)
        lrs[side] = model._optimizer.get_lr()
    assert lrs["torch"] == lrs["jax"] == pytest.approx(0.025)


def test_metrics_dump_callback(tmp_path):
    X, Y = _mlp_data()
    path = str(tmp_path / "m.jsonl")
    net = _mlp(tnn, tpaddle)
    model = thapi.Model(net)
    model.prepare(topt.SGD(0.1, parameters=net.parameters()),
                  tnn.CrossEntropyLoss())
    model.fit(tio.TensorDataset([X, Y]), batch_size=32, epochs=2,
              verbose=0, callbacks=[thapi.MetricsDump(path)])
    rows = [json.loads(ln) for ln in open(path)]
    assert [r["tag"] for r in rows] == ["epoch_end", "epoch_end",
                                        "train_end"]


def test_progbar_logger_prints(capsys):
    X, Y = _mlp_data()
    net = _mlp(tnn, tpaddle)
    model = thapi.Model(net)
    model.prepare(topt.SGD(0.1, parameters=net.parameters()),
                  tnn.CrossEntropyLoss())
    model.fit(tio.TensorDataset([X, Y]), batch_size=32, epochs=1,
              verbose=1, log_freq=1)
    out = capsys.readouterr().out
    assert "Epoch 1/1" in out and "step 1/2 - loss:" in out


# -- the Checkpoint callback (test_fault_tolerance.py) -----------------------
def test_checkpoint_callback_releases_sigterm_handler_on_crash(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    net = tnn.Linear(4, 1)
    m = thapi.Model(net)

    def exploding_loss(out, label):
        raise ZeroDivisionError("boom")

    m.prepare(topt.SGD(learning_rate=0.1, parameters=net.parameters()),
              loss=exploding_loss, jit_compile=False)
    x, y = np.zeros((4, 4), np.float32), np.zeros((4, 1), np.float32)
    with pytest.raises(ZeroDivisionError):
        m.fit([(x, y)], epochs=1, verbose=0,
              callbacks=[thapi.Checkpoint(str(tmp_path / "crash"))])
    assert signal.getsignal(signal.SIGTERM) == prev


def test_checkpoint_callback_saves_restores_and_rotates(tmp_path):
    x = np.random.RandomState(5).randn(16, 4).astype(np.float32)
    y = np.random.RandomState(6).randn(16, 1).astype(np.float32)
    w0 = {"weight": np.random.RandomState(7).randn(4, 1).astype(np.float32),
          "bias": np.zeros(1, np.float32)}
    trained = {}
    for side, (paddle, hapi, _, nn, opt, F, _) in SIDES.items():
        d = str(tmp_path / side)

        def make_model():
            net = _load(paddle, nn.Linear(4, 1), w0)
            m = hapi.Model(net)
            m.prepare(opt.SGD(learning_rate=0.05,
                              parameters=net.parameters()),
                      loss=F.mse_loss, jit_compile=False)
            return m

        m1 = make_model()
        m1.fit(list(zip(x.reshape(4, 4, 4), y.reshape(4, 4, 1))), epochs=3,
               verbose=0, callbacks=[hapi.Checkpoint(d,
                                                     keep_checkpoint_max=2)])
        trained[side] = _np(m1.network.weight).copy()
        meta = json.load(open(os.path.join(d, "range_meta.json")))
        assert [s["epoch"] for s in meta["snapshots"]] == [1, 2]
        m2 = make_model()
        cb = hapi.Checkpoint(d)
        cb.set_model(m2)
        cb.on_train_begin()
        np.testing.assert_array_equal(_np(m2.network.weight), trained[side])
        assert cb.last_restored_epoch == 2
        cb.on_train_end()
    np.testing.assert_allclose(trained["torch"], trained["jax"], rtol=1e-5)


# -- inference export --------------------------------------------------------
def test_model_save_inference_and_serve(tmp_path):
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.jit import InputSpec
    tpaddle.seed(0)
    net = tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2))
    m = thapi.Model(net, inputs=[InputSpec([None, 4], "float32")])
    prefix = os.path.join(str(tmp_path), "served")
    m.save(prefix, training=False)
    x = np.random.RandomState(0).standard_normal((3, 4)).astype(np.float32)
    net.eval()
    want = net(tpaddle.to_tensor(x)).numpy()
    pred = inference.create_predictor(inference.Config(prefix))
    got, = pred.run([x])
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-3, atol=1e-5)


def test_dataset_folder_with_transform_trains(tmp_path):
    import paddle_tpu_torch.vision.transforms as T
    from paddle_tpu_torch.vision.datasets import DatasetFolder
    root = tmp_path / "imgs"
    r = np.random.RandomState(8)
    for ci, cls in enumerate(("a", "b")):
        os.makedirs(root / cls)
        for i in range(8):
            np.save(root / cls / f"{i}.npy",
                    (r.rand(8, 8, 3) + ci).astype(np.float32))
    ds = DatasetFolder(str(root), transform=T.Compose([
        T.Transpose(), T.Normalize(mean=[0.5] * 3, std=[0.5] * 3)]))
    tpaddle.seed(102)
    net = tnn.Sequential(tnn.Flatten(), tnn.Linear(3 * 8 * 8, 2))
    model = thapi.Model(net)
    model.prepare(topt.Adam(learning_rate=1e-2, parameters=net.parameters()),
                  lambda o, y: TF.cross_entropy(o, y))
    hist = model.fit(ds, batch_size=4, epochs=3, verbose=0)
    assert hist["loss"][-1] < hist["loss"][0]


# -- the slice: a small BERT fitted by hapi.Model in both packages -----------
BERT = dict(vocab=300, hidden=64, layers=2, heads=4, ffn=128, seq=32,
            batch=8, docs=24)


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bert_fitted_by_hapi_matches_paddle_tpu(tmp_path):
    """A 2-layer BERT (hidden 64, 4 heads, seq 32) over a WordPiece
    corpus, f32 and dropout 0: 3 ``fit`` steps of AdamW(1e-4, wd 0.01)
    with a global-norm clip, in each package from the same weights over
    the same tokenized batches; losses within 1e-5 relative, and the
    ``evaluate`` losses too."""
    from paddle_tpu.text import FastWordPieceTokenizer as JTok
    from paddle_tpu_torch.testing import corpus
    from paddle_tpu_torch.testing.models import build_model, mlm_loss
    c = BERT
    vocab, docs = corpus.write_corpus(str(tmp_path), c["docs"], c["vocab"],
                                      words_per_doc=(20, 40), seed=3)
    ds = corpus.MaskedLMCorpus(vocab, docs, c["seq"])
    text = open(docs).read().splitlines()
    np.testing.assert_array_equal(
        ds.tokenizer().encode_batch(text, c["seq"])[0],
        JTok(vocab).encode_batch(text, c["seq"])[0])
    bench = _bench()
    jpaddle.seed(2024)
    jm = bench.build_model(c["vocab"], c["hidden"], c["layers"], c["heads"],
                           c["ffn"], c["seq"], 0.0)
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    tm = build_model(c["vocab"], c["hidden"], c["layers"], c["heads"],
                     c["ffn"], c["seq"], 0.0, device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(state, "cpu", model=tm))

    def jloss(out, labels):
        return JF.linear_cross_entropy(out.reshape([-1, c["hidden"]]),
                                       jm.head.weight, jm.head.bias,
                                       labels.reshape([-1]))

    got = {}
    for side, net, loss in (("jax", jm, jloss), ("torch", tm, mlm_loss(tm))):
        paddle, hapi, io, _, opt, _, _ = SIDES[side]
        model = paddle.Model(net)
        model.prepare(opt.AdamW(
            learning_rate=1e-4, parameters=net.parameters(),
            weight_decay=0.01, grad_clip=opt.ClipGradByGlobalNorm(1.0)),
            loss)
        losses = []
        model.fit(io.DataLoader(ds, batch_size=c["batch"]), epochs=1,
                  verbose=0, log_freq=1,
                  callbacks=[_Losses.make(hapi, losses)])
        ev = model.evaluate(io.DataLoader(io.Subset(ds, range(16)),
                                          batch_size=c["batch"]),
                            verbose=0)
        got[side] = (losses, ev["loss"])
    assert len(got["torch"][0]) == 3
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-5)
    np.testing.assert_allclose(got["torch"][1], got["jax"][1], rtol=1e-5)
    assert abs(got["torch"][0][0] - np.log(c["vocab"])) < 0.5
