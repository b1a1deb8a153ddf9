"""``PagedDecoderLM.init_cell_state`` / ``make_cell`` (the dense
padded-cache baseline of ``bench_generation``) held to paddle_tpu's on
the CPU, from the same weights (``params_from_paddle_tpu``):

- the prefilled K/V caches and positions, within 1e-5;
- the cell's logits over 8 greedy steps (MHA and GQA), within 1e-5;
- ``nn.dynamic_decode`` over the cell (beam 1, a numpy budget as in
  bench.py): the same tokens, each sequence ending in EOS right after
  its budget;
- the cell writes no state it is given, and the prompt checks raise.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn, serving as jserving
from paddle_tpu_torch import nn as tnn, serving as tserving

TOL = dict(rtol=1e-5, atol=1e-5)
EOS = 63


def _pair(num_kv_heads=0):
    kw = dict(vocab_size=64, hidden=32, num_layers=2, num_heads=4,
              num_kv_heads=num_kv_heads, ffn=64, seed=7)
    jm = jserving.PagedDecoderLM(**kw)
    tm = tserving.PagedDecoderLM(**kw, device="cpu")
    tm.load_state_dict(tserving.params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jm.params.items()}, "cpu"))
    return jm, tm


@pytest.mark.parametrize("prompt", [[5], [3, 5, 7, 9, 11], list(range(1, 17))])
def test_init_cell_state_matches(prompt):
    jm, tm = _pair()
    js, ts = jm.init_cell_state(prompt, 24), tm.init_cell_state(prompt, 24)
    assert set(js) == set(ts) == {"k", "v", "pos", "gen", "limit"}
    for k in ("k", "v"):
        assert tuple(ts[k].shape) == tuple(js[k].shape) == (1, 2, 24, 4, 8)
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **TOL)
    for k in ("pos", "gen", "limit"):
        assert ts[k].dtype == torch.int32
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


@pytest.mark.parametrize("num_kv_heads", [0, 2])
def test_cell_logits_over_8_steps(num_kv_heads):
    jm, tm = _pair(num_kv_heads)
    prompt = [3, 5, 7, 9, 11]
    js, ts = jm.init_cell_state(prompt, 32), tm.init_cell_state(prompt, 32)
    js["limit"] = np.full((1,), 5, np.int32)
    ts["limit"] = torch.full((1,), 5, dtype=torch.int32)
    jc, tc = jm.make_cell(EOS), tm.make_cell(EOS)
    tok = prompt[-1]
    for step in range(8):
        jl, js = jc(np.array([tok], np.int32), js)
        before = {k: v.clone() for k, v in ts.items()}
        tl, ts_new = tc(torch.tensor([tok]), ts)
        for k, v in ts.items():         # the given states are not written
            assert torch.equal(v, before[k]), k
        ts = ts_new
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        if step >= 5:                   # past the budget: EOS only
            assert int(tl.argmax()) == EOS
        tok = int(np.argmax(np.asarray(jl)[0]))
    np.testing.assert_array_equal(ts["pos"].numpy(), np.asarray(js["pos"]))


def _generate(m, dnn, prompt, limit):
    dec = dnn.BeamSearchDecoder(m.make_cell(EOS), start_token=prompt[-1],
                                end_token=EOS, beam_size=1)
    st = m.init_cell_state(prompt, 64)
    st["limit"] = np.full((1,), limit, np.int32)
    seq, _, lens = dnn.dynamic_decode(dec, st, max_step_num=limit + 4,
                                      return_length=True, cache=True)
    n = int(np.asarray(lens.numpy())[0, 0])
    return np.asarray(seq.numpy())[0, 0, :n]


def test_dynamic_decode_tokens_match():
    jm, tm = _pair()
    rng = np.random.RandomState(42)
    for _ in range(3):
        prompt = rng.randint(0, 60, rng.randint(1, 9)).tolist()
        budget = int(rng.randint(2, 7))
        want = _generate(jm, jnn, prompt, budget)
        got = _generate(tm, tnn, prompt, budget)
        np.testing.assert_array_equal(got, want)
        assert len(got) == budget + 1 and got[-1] == EOS


def test_prompt_checks():
    _, tm = _pair()
    with pytest.raises(ValueError, match="at least one token"):
        tm.init_cell_state([], 8)
    with pytest.raises(ValueError, match="t_max"):
        tm.init_cell_state(list(range(10)), 8)
