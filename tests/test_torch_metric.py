"""``metric`` against paddle_tpu's on the same seeded numpy inputs, given
to each package as its own tensors.  The counts are host-side numpy in
both, so results agree exactly (``accuracy``, the one device op, within
1e-7)."""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _scores(n=64, c=10, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, c).astype("float32"),
            rs.randint(0, c, (n, 1)).astype("int64"))


@pytest.mark.parametrize("topk", [1, (1, 5), (2, 3)])
def test_accuracy_matches(cpu, topk):
    accs = []
    for pkg in (paddle_tpu, cpu):
        m = pkg.metric.Accuracy(topk=topk)
        per_batch = []
        for seed in range(3):
            pred, label = _scores(seed=seed)
            correct = m.compute(pkg.to_tensor(pred), pkg.to_tensor(label))
            per_batch.append(m.update(correct))
        accs.append((per_batch, m.accumulate(), m.name()))
        m.reset()
        assert m.accumulate() == (0.0 if isinstance(topk, int)
                                  else [0.0] * len(topk))
    assert accs[1] == accs[0]


def _binary(n=200, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n).astype("float32"),
            rs.randint(0, 2, (n,)).astype("int64"))


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_and_recall_match(cpu, cls):
    got = []
    for pkg in (paddle_tpu, cpu):
        m = getattr(pkg.metric, cls)()
        for seed in range(3):
            p, lab = _binary(seed=seed)
            m.update(pkg.to_tensor(p), pkg.to_tensor(lab))
        got.append((m.accumulate(), m.name()))
    assert got[1] == got[0]
    assert 0.0 < got[0][0] < 1.0


@pytest.mark.parametrize("two_columns,thresholds", [(False, 4095),
                                                    (True, 255)])
def test_auc_matches(cpu, two_columns, thresholds):
    got = []
    for pkg in (paddle_tpu, cpu):
        m = pkg.metric.Auc(num_thresholds=thresholds)
        for seed in range(2):
            p, lab = _binary(seed=seed)
            # scores that lean toward the label, so the AUC is not 0.5
            p = np.clip(p * 0.7 + lab * 0.3, 0, 1).astype("float32")
            if two_columns:
                p = np.stack([1 - p, p], 1)
            m.update(pkg.to_tensor(p), pkg.to_tensor(lab))
        got.append(m.accumulate())
    assert got[1] == pytest.approx(got[0], rel=1e-12)
    assert 0.6 < got[0] < 1.0


@pytest.mark.parametrize("k,label_2d", [(1, False), (3, True)])
def test_functional_accuracy_matches(cpu, k, label_2d):
    pred, label = _scores(n=32, c=7)
    if not label_2d:
        label = label[:, 0]
    j = paddle_tpu.metric.accuracy(paddle_tpu.to_tensor(pred),
                                   paddle_tpu.to_tensor(label), k=k)
    t = cpu.metric.accuracy(cpu.to_tensor(pred), cpu.to_tensor(label), k=k)
    assert isinstance(t, cpu.Tensor) and t.shape == []
    np.testing.assert_allclose(t.numpy(), np.asarray(j.data), atol=1e-7)
