"""Beam search and ``gather_tree`` on both packages on the CPU: the cases
of ``tests/test_decode.py`` run on paddle_tpu and on the port alike (a
deterministic toy LM whose best beams are known), the hand-computed
``gather_tree`` trellis, early exit, lengths and ``cell_step``; then the
port's ids, scores and lengths against paddle_tpu's for a GRU LM with
carried weights, exact ties broken as ``lax.top_k`` breaks them (the
lower index first), the sync-free loop's cell calls, the shape check on
the states, and ``cache=True`` (a kept difference: nothing is
compiled).  A ``cuda`` test holds the card's beams to the CPU's, id for
id."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement

PKGS = [paddle_tpu, paddle_tpu_torch]
IDS = ["paddle_tpu", "paddle_tpu_torch"]


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield
    placement.set_default(prev)


def _toy_cell(pkg, table):
    class ToyCell(pkg.nn.Layer):
        """Next-token logits from a fixed table; the state counts
        steps."""

        def __init__(self):
            super().__init__()
            self.table = pkg.to_tensor(table)
            self.calls = 0

        def forward(self, tok, states):
            self.calls += 1
            return self.table[tok], states + 1
    return ToyCell()


def _np(t):
    return np.asarray(t.numpy())


def _chain_table(V):
    tbl = np.full((V, V), -5.0, np.float32)
    for i in range(V):
        tbl[i, (i + 1) % V] = 5.0
    return tbl


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_greedy_beam_follows_argmax_chain(pkg):
    dec = pkg.nn.BeamSearchDecoder(_toy_cell(pkg, _chain_table(5)),
                                   start_token=1, end_token=0, beam_size=2)
    seq, _ = pkg.nn.dynamic_decode(dec, pkg.zeros([3], dtype="int32"),
                                   max_step_num=8)
    seq = _np(seq)
    assert seq.shape == (3, 2, 8)
    np.testing.assert_array_equal(seq[0, 0, :4], [2, 3, 4, 0])
    np.testing.assert_array_equal(seq[0], seq[1])


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_beams_are_sorted_and_lengths_reported(pkg):
    tbl = np.zeros((4, 4), np.float32)
    tbl[1, 2], tbl[1, 3], tbl[2, 0], tbl[3, 0] = 3.0, 1.0, 5.0, 5.0
    dec = pkg.nn.BeamSearchDecoder(_toy_cell(pkg, tbl), start_token=1,
                                   end_token=0, beam_size=2)
    seq, scores, lens = pkg.nn.dynamic_decode(
        dec, pkg.zeros([1], dtype="int32"), max_step_num=6,
        return_length=True)
    s = _np(scores)[0]
    assert s[0] >= s[1]
    assert _np(seq)[0, 0, 0] == 2
    assert _np(lens)[0, 0] == 2


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_gather_tree_backtracks(pkg):
    ids = np.array([[[5, 6]], [[7, 8]], [[9, 10]]], np.int32)
    parents = np.array([[[0, 0]], [[1, 0]], [[0, 1]]], np.int32)
    got = _np(pkg.nn.gather_tree(pkg.to_tensor(ids), pkg.to_tensor(parents)))
    np.testing.assert_array_equal(got[:, 0, 0], [6, 7, 9])
    np.testing.assert_array_equal(
        got, _np(pkg.nn.functional.gather_tree(pkg.to_tensor(ids),
                                               pkg.to_tensor(parents))))


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_gather_tree_hand_computed_trellis(pkg):
    ids = np.array(
        [[[10, 11, 12], [20, 21, 22]],
         [[13, 14, 15], [23, 24, 25]],
         [[16, 17, 18], [26, 27, 28]],
         [[19, 30, 31], [29, 32, 33]]], np.int32)
    parents = np.array(
        [[[0, 0, 0], [0, 0, 0]],
         [[2, 0, 1], [1, 2, 0]],
         [[1, 2, 0], [0, 1, 2]],
         [[2, 0, 1], [2, 0, 1]]], np.int32)
    got = _np(pkg.nn.gather_tree(pkg.to_tensor(ids), pkg.to_tensor(parents)))
    np.testing.assert_array_equal(got[:, 0, 0], [12, 13, 18, 19])
    np.testing.assert_array_equal(got[:, 0, 1], [10, 14, 16, 30])
    np.testing.assert_array_equal(got[:, 1, 2], [22, 24, 27, 33])


def _two_step_table(V=6, eos=5):
    tbl = np.full((V, V), -9.0, np.float32)
    tbl[1, 2], tbl[1, 3] = 2.0, 1.0
    tbl[2, eos] = tbl[3, eos] = 9.0
    return tbl


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_early_exit_preserves_distinct_beams(pkg):
    dec = pkg.nn.BeamSearchDecoder(_toy_cell(pkg, _two_step_table()),
                                   start_token=1, end_token=5, beam_size=2)
    seq, _ = pkg.nn.dynamic_decode(dec, pkg.zeros([1], dtype="int32"),
                                   max_step_num=10)
    s = _np(seq)[0]
    np.testing.assert_array_equal(s[0, :2], [2, 5])
    np.testing.assert_array_equal(s[1, :2], [3, 5])
    assert np.all(s[:, 2:] == 5)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_early_exit_matches_exact_horizon(pkg):
    dec = pkg.nn.BeamSearchDecoder(_toy_cell(pkg, _two_step_table()),
                                   start_token=1, end_token=5, beam_size=2)

    def run(t_max):
        return [_np(t) for t in pkg.nn.dynamic_decode(
            dec, pkg.zeros([2], dtype="int32"), max_step_num=t_max,
            return_length=True)]

    s_big, sc_big, l_big = run(40)
    s_exact, sc_exact, l_exact = run(2)
    np.testing.assert_array_equal(s_big[:, :, :2], s_exact)
    np.testing.assert_array_equal(sc_big, sc_exact)
    np.testing.assert_array_equal(l_big, l_exact)
    assert np.all(s_big[:, :, 2:] == 5)


def test_early_exit_stops_calling_the_cell():
    """Every beam has finished after two steps: the port's loop calls
    the cell twice for a budget of 40 (its one host read a step is the
    exit test)."""
    cell = _toy_cell(paddle_tpu_torch, _two_step_table())
    dec = paddle_tpu_torch.nn.BeamSearchDecoder(cell, 1, 5, 2)
    paddle_tpu_torch.nn.dynamic_decode(
        dec, paddle_tpu_torch.zeros([2], dtype="int32"), max_step_num=40)
    assert cell.calls == 2


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_cell_step_single_step_api(pkg):
    V = 5
    tbl = np.arange(V * V, dtype=np.float32).reshape(V, V) / 10.0
    dec = pkg.nn.BeamSearchDecoder(_toy_cell(pkg, tbl), start_token=1,
                                   end_token=0, beam_size=2)
    toks = np.array([1, 4, 2], np.int32)
    logp, new_states = pkg.nn.cell_step(dec, toks,
                                        pkg.zeros([3], dtype="int32"))
    logp = np.asarray(logp)
    assert logp.shape == (3, V) and logp.dtype == np.float32
    ref = tbl[toks]
    m = ref.max(-1, keepdims=True)
    ref = ref - m - np.log(np.exp(ref - m).sum(-1, keepdims=True))
    np.testing.assert_allclose(logp, ref, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(new_states), [1, 1, 1])


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_cache_true_gives_the_uncached_result(pkg):
    """``cache=True`` with another start token and again: the same ids
    as the plain call.  paddle_tpu compiles the loop once and replays
    it; the port keeps nothing to compile (a kept difference)."""
    dec = pkg.nn.BeamSearchDecoder(_toy_cell(pkg, _chain_table(5)),
                                   start_token=1, end_token=0, beam_size=2)
    inits = pkg.zeros([2], dtype="int32")
    s1 = _np(pkg.nn.dynamic_decode(dec, inits, max_step_num=6,
                                   cache=True)[0])
    dec.start_token = 2
    s2 = _np(pkg.nn.dynamic_decode(dec, inits, max_step_num=6,
                                   cache=True)[0])
    np.testing.assert_array_equal(s2[0, 0, :3], [3, 4, 0])
    dec.start_token = 1
    np.testing.assert_array_equal(
        s1, _np(pkg.nn.dynamic_decode(dec, inits, max_step_num=6)[0]))


def _tie_table(V=6, eos=0):
    """Tokens 2 and 4 tie after the start and every continuation ties:
    only the tie rule picks the beams."""
    tbl = np.zeros((V, V), np.float32)
    tbl[1, 2] = tbl[1, 4] = 3.0
    tbl[2, eos] = tbl[4, eos] = 1.0
    return tbl


def test_exact_ties_keep_the_lower_index_first():
    out = {}
    for pkg in PKGS:
        dec = pkg.nn.BeamSearchDecoder(_toy_cell(pkg, _tie_table()), 1, 0, 3)
        out[pkg.__name__] = [_np(t) for t in pkg.nn.dynamic_decode(
            dec, pkg.zeros([2], dtype="int32"), max_step_num=5,
            return_length=True)]
    for j, t in zip(out["paddle_tpu"], out["paddle_tpu_torch"]):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(out["paddle_tpu_torch"][0][0, 0, :2],
                                  [2, 0])


def _gru_lm(pkg, H, V):
    class GruLM(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.cell = pkg.nn.GRUCell(H, H)

        def forward(self, x, states):
            return self.cell(x, states)
    return pkg.nn.Embedding(V, H), GruLM(), pkg.nn.Linear(H, V)


def test_gru_beam_search_matches_paddle_tpu():
    """Beam 3 over a GRU LM with an embedding and a projection, the
    port's ids, lengths and scores against paddle_tpu's from the same
    weights: ids and lengths equal, scores within 1e-5."""
    H, V = 8, 12
    parts = {}
    for pkg in PKGS:
        pkg.seed(0)
        parts[pkg.__name__] = _gru_lm(pkg, H, V)
    rs = np.random.RandomState(3)
    for j, t in zip(parts["paddle_tpu"], parts["paddle_tpu_torch"]):
        for (kj, pj), (kt, pt) in zip(sorted(j.named_parameters()),
                                      sorted(t.named_parameters())):
            assert kj == kt
            w = rs.uniform(-0.8, 0.8, tuple(pj.shape)).astype(np.float32)
            pj.set_value(w)
            pt.set_value(w)
    h0 = rs.randn(2, H).astype(np.float32)
    out = {}
    for pkg in PKGS:
        emb, lm, proj = parts[pkg.__name__]
        dec = pkg.nn.BeamSearchDecoder(lm, start_token=1, end_token=0,
                                       beam_size=3, embedding_fn=emb,
                                       output_fn=proj)
        out[pkg.__name__] = [_np(t) for t in pkg.nn.dynamic_decode(
            dec, pkg.to_tensor(h0), max_step_num=6, return_length=True)]
    (js, jsc, jl), (ts, tsc, tl) = out["paddle_tpu"], out["paddle_tpu_torch"]
    assert ts.shape == (2, 3, 6)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-5)
    assert np.all(np.diff(tsc, axis=1) <= 0)


def test_a_state_that_changes_shape_raises():
    class Grow(paddle_tpu_torch.nn.Layer):
        def forward(self, tok, states):
            logits = paddle_tpu_torch.zeros([tok.shape[0], 4])
            return logits, paddle_tpu_torch.concat([states, states], 1)
    dec = paddle_tpu_torch.nn.BeamSearchDecoder(Grow(), 1, 0, 2)
    with pytest.raises(ValueError, match="changed its shape"):
        paddle_tpu_torch.nn.dynamic_decode(
            dec, paddle_tpu_torch.zeros([2, 3]), max_step_num=3)


@pytest.mark.cuda
def test_cuda_beams_equal_the_cpus():
    """The GRU LM's beam search on the card, ids and lengths equal to
    the CPU's, scores within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, V = 16, 50
    out = {}
    for where in ("cpu", "gpu"):
        paddle_tpu_torch.set_device(where)
        emb, lm, proj = _gru_lm(paddle_tpu_torch, H, V)
        rs = np.random.RandomState(5)
        for layer in (emb, lm, proj):
            for _, p in sorted(layer.named_parameters()):
                p.set_value(rs.uniform(-0.8, 0.8, tuple(p.shape)).astype(
                    np.float32))
        h0 = paddle_tpu_torch.to_tensor(
            np.random.RandomState(4).randn(4, H).astype(np.float32))
        dec = paddle_tpu_torch.nn.BeamSearchDecoder(lm, 1, 0, 4, emb, proj)
        seq, sc, ln = paddle_tpu_torch.nn.dynamic_decode(
            dec, h0, max_step_num=12, return_length=True)
        assert seq.place.startswith("cuda" if where == "gpu" else "cpu")
        out[where] = [_np(t) for t in (seq, sc, ln)]
    np.testing.assert_array_equal(out["gpu"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["gpu"][2], out["cpu"][2])
    np.testing.assert_allclose(out["gpu"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-5)
