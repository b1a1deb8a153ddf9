"""paddle_tpu_torch paged attention held to paddle_tpu.

The port's plain ``paged_attention_reference`` against the JAX
reference and against the Pallas decode kernel in interpret mode, on
the same seeded numpy inputs: 4-D pool, stacked pool with ``layer``,
GQA and ragged lengths >= 1.  f32 atol 2e-6: both sides accumulate the
same f32 products, summed in different orders.  The CUDA kernel itself
is held to the plain version on the card (``-m cuda``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import serving as jax_serving
from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.ops.pallas.paged_attention import \
    paged_attention_decode as pallas_decode
from paddle_tpu_torch import serving as torch_serving
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.ops import attention as torch_attention
from paddle_tpu_torch.ops import cuda as torch_cuda
from paddle_tpu_torch.testing import kernel_times

ATOL = 2e-6


def _case(seed, S=3, H=4, Hkv=2, D=128, page=8, P=4, N=12, layers=0,
          lengths=(1, 13, 32)):
    r = np.random.RandomState(seed)
    pool_shape = (layers, N, page, Hkv, D) if layers else (N, page, Hkv, D)
    return dict(q=r.randn(S, H, D).astype(np.float32),
                k=r.randn(*pool_shape).astype(np.float32),
                v=r.randn(*pool_shape).astype(np.float32),
                table=r.randint(0, N, (S, P)).astype(np.int32),
                lengths=np.asarray(lengths, np.int32)[:S])


def _torch(c, layer=None, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in c.items()}
    return torch_attention.paged_attention_reference(
        t["q"], t["k"], t["v"], t["table"], t["lengths"], layer=layer)


def _jax(c, layer=None):
    return np.asarray(jax_attention.paged_attention_reference(
        *(jnp.asarray(c[k]) for k in ("q", "k", "v", "table", "lengths")),
        layer=layer))


def _pallas(c, layer=None):
    return np.asarray(pallas_decode(
        *(jnp.asarray(c[k]) for k in ("q", "k", "v", "table", "lengths")),
        layer=layer, interpret=True))


@pytest.mark.parametrize("heads", [(4, 2), (4, 4), (8, 2)],
                         ids=["gqa2", "mha", "gqa4"])
def test_reference_matches_jax_4d_pool(heads):
    H, Hkv = heads
    c = _case(0, H=H, Hkv=Hkv)
    got = _torch(c).numpy()
    np.testing.assert_allclose(got, _jax(c), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _pallas(c), atol=ATOL, rtol=0)


def test_reference_matches_jax_stacked_pool_per_layer():
    c = _case(1, layers=3)
    for layer in range(3):
        got = _torch(c, layer=layer).numpy()
        np.testing.assert_allclose(got, _jax(c, layer), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, _pallas(c, layer), atol=ATOL,
                                   rtol=0)


def test_reference_ragged_lengths_and_narrow_head_dim():
    # head_dim 8 is below the Pallas kernel's 128-lane gate: reference
    # to reference only
    c = _case(2, S=4, H=2, Hkv=1, D=8, page=4, P=3, N=7,
              lengths=(1, 5, 12, 7))
    np.testing.assert_allclose(_torch(c).numpy(), _jax(c), atol=ATOL,
                               rtol=0)


def test_reference_length_zero_follows_the_jax_reference():
    """At length 0 the plain version (like the JAX reference) returns
    the mean of V over the table; the kernels return zeros there."""
    c = _case(3, S=2, lengths=(0, 9))
    got = _torch(c).numpy()
    np.testing.assert_allclose(got, _jax(c), atol=ATOL, rtol=0)
    assert np.abs(got[0]).max() > 0
    assert np.abs(_pallas(c)[0]).max() == 0


def test_select_routes_cpu_tensors_to_the_plain_version():
    c = _case(4)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    before = dict(torch_cuda.support.launch_counts)
    got = torch_attention.paged_attention_select(
        t["q"], t["k"], t["v"], t["table"], t["lengths"],
        scale=1 / np.sqrt(128))
    assert torch.equal(got, _torch(c))
    assert torch_cuda.support.launch_counts == before


@pytest.mark.parametrize("case", ["d128_group2", "d96", "flag_off",
                                  "group3", "cpu"])
def test_supported_is_the_kernels_capability_gate(case):
    """The decode kernel takes the call only where its gates agree: the
    flag on, CUDA, f32/bf16, a built head dim and GQA group; everything
    else is served by the plain version (the reference's dispatch)."""
    H, Hkv, D, device, flag = 8, 4, 128, "cuda", True
    if case == "d96":
        D = 96
    elif case == "flag_off":
        flag = False
    elif case == "group3":
        H, Hkv = 6, 2
    elif case == "cpu":
        device = "cpu"
    set_flags({"use_pallas_kernels": flag})
    try:
        got = torch_attention.paged_attention_supported(
            (4, H, D), (2, 12, 16, Hkv, D), torch.bfloat16, 16,
            torch.device(device))
    finally:
        set_flags({"use_pallas_kernels": True})
    assert got is (case == "d128_group2")
    # the same call at f32, and a dtype no kernel takes
    if case == "d128_group2":
        assert torch_attention.paged_attention_supported(
            (4, H, D), (12, 16, Hkv, D), torch.float32, 16, "cuda")
        assert not torch_attention.paged_attention_supported(
            (4, H, D), (12, 16, Hkv, D), torch.float16, 16, "cuda")


def _decoder_logits_head_dim_96(lm, zeros, tensor):
    """Prefill one prompt, then three decode steps, on a 2-layer model
    with head dim 96; the logits of every call."""
    L, N, page, Hkv, D = 2, 9, 4, 1, 96
    kv = (zeros((L, N, page, Hkv, D)), zeros((L, N, page, Hkv, D)))
    table = tensor(np.arange(1, 5, dtype=np.int32))
    toks = tensor((np.arange(8, dtype=np.int32) * 5) % 64)
    logits, kv = lm.prefill(toks, 6, kv, table)
    out = [np.asarray(logits)]
    tables = tensor(np.stack([np.arange(1, 5), np.arange(5, 9)])
                    .astype(np.int32))
    for pos in (6, 7, 8):
        tok = tensor(np.asarray([pos * 3 % 64, 1], np.int32))
        positions = tensor(np.asarray([pos, 0], np.int32))
        logits, kv = lm.decode(tok, positions, kv, tables)
        out.append(np.asarray(logits)[0])
    return out


def test_decoder_at_head_dim_96_gives_the_jax_logits():
    """A PagedDecoderLM at head dim 96 (no kernel instance) decodes
    through paged_attention_select's plain path and gives the JAX
    package's logits (the same dyadic weights; f32 sums in other
    orders)."""
    geom = dict(vocab_size=64, hidden=192, num_layers=2, num_heads=2,
                num_kv_heads=1)
    jlm = jax_serving.PagedDecoderLM(seed=6, dyadic=True, **geom)
    tlm = torch_serving.PagedDecoderLM(device="cpu", **geom)
    tlm.load_state_dict(torch_serving.params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jlm.params.items()}, "cpu"))
    assert tlm.head_dim == 96
    before = dict(torch_cuda.support.launch_counts)
    got = _decoder_logits_head_dim_96(
        tlm, lambda s: torch.zeros(s), torch.from_numpy)
    want = _decoder_logits_head_dim_96(
        jlm, lambda s: jnp.zeros(s, jnp.float32), jnp.asarray)
    assert torch_cuda.support.launch_counts == before
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    c = _case(5)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    with pytest.raises(ValueError, match="CUDA"):
        torch_cuda.paged_attention_decode(t["q"], t["k"], t["v"],
                                          t["table"], t["lengths"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 1e-2)])
def test_cuda_kernel_matches_plain_version(dtype, atol):
    """On the card: kernel vs plain version on the same inputs (f32
    2e-5 for the reordered f32 sums; bf16 inputs, both accumulating in
    f32, 1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for c, layer in ((_case(6, layers=3), 1),
                     (_case(7, H=16, Hkv=4, lengths=(1, 32, 20)), None),
                     (_case(8, H=4, Hkv=2, D=64), None),
                     (_case(9, H=8, Hkv=1, D=256, layers=2), 0)):
        t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
        q, k, v = (t[n].to(dtype) for n in ("q", "k", "v"))
        got = torch_cuda.paged_attention_decode(
            q, k, v, t["table"], t["lengths"], layer=layer)
        ref = torch_attention.paged_attention_reference(
            q, k, v, t["table"], t["lengths"], layer=layer)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= atol, err


@pytest.mark.cuda
@pytest.mark.parametrize("D,launches", [(96, 0), (128, 1)])
def test_cuda_select_launches_the_kernel_only_where_it_is_built(D,
                                                                launches):
    """On the card, paged_attention_select serves a head dim the kernel
    has no instance for (96) by the plain version, with no launch, and
    a built one (128) by one launch; both agree with the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = _case(11, H=4, Hkv=2, D=D, layers=2)
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    torch_cuda.support.reset_launch_counts()
    got = torch_attention.paged_attention_select(
        t["q"], t["k"], t["v"], t["table"], t["lengths"],
        scale=1 / np.sqrt(D), layer=1)
    n = torch_cuda.support.launch_counts.get("paged_attention", 0)
    ref = torch_attention.paged_attention_reference(
        t["q"], t["k"], t["v"], t["table"], t["lengths"],
        scale=1 / np.sqrt(D), layer=1)
    torch.cuda.synchronize()
    assert n == launches
    assert (got - ref).abs().max().item() <= 2e-5
    if D == 96:            # the kernel's wrapper still refuses it
        with pytest.raises(ValueError, match="head_dim"):
            torch_cuda.paged_attention_decode(
                t["q"], t["k"], t["v"], t["table"], t["lengths"], layer=1)


@pytest.mark.cuda
def test_cuda_kernel_length_zero_and_bad_page_id():
    """The kernel's documented edges: length 0 gives zeros (as the TPU
    kernel), a live page id outside the pool gives NaN for that slot
    only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = _case(10, lengths=(0, 9, 20))
    c["table"][2, 1] = 12                     # N = 12: one past the pool
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    got = torch_cuda.paged_attention_decode(t["q"], t["k"], t["v"],
                                            t["table"], t["lengths"])
    ref = torch_attention.paged_attention_reference(
        t["q"], t["k"], t["v"], t["table"].clamp(max=11), t["lengths"])
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0
    assert (got[1] - ref[1]).abs().max().item() <= 2e-5
    assert torch.isnan(got[2]).all()


# clusters of 1..8 blocks an H100 holds at once for a small instance
# (4 blocks an SM; a cluster's blocks share one GPC)
_H100 = [528, 264, 176, 132, 105, 88, 75, 66]


@pytest.mark.parametrize("work,resident,want", [
    (112, _H100, 4),                # S 8 x Hkv 14: 4 x 112 in one wave
    (112, [396, 198, 132, 99, 79, 66, 56, 49], 3),
    (1000, _H100, 1),               # more slots than the card holds
    (8, [10000] * 8, 8),            # the portable cluster size
    (112, [600] + [0] * 7, 1),      # no cluster can be placed
    (66, _H100, 8),                 # exactly resident
    (67, _H100, 7)])
def test_cluster_size_keeps_the_grid_resident(work, resident, want):
    """The blocks a slot is split over come from what is fixed per engine
    (S x Hkv and the card's resident clusters of each size), never from
    the table width or the lengths: the most that keep the grid
    resident, at most 8."""
    assert torch_cuda.paged_attention.cluster_size(work, resident) == want


@pytest.mark.parametrize("clusters,P,page,want", [
    (4, 1, 16, 1),                  # one page: one share, no cluster
    (4, 2, 16, 1),                  # 32 tokens: still one share
    (4, 3, 16, 2),
    (4, 8, 16, 4),
    (4, 64, 16, 4),                 # the split bounds the cluster
    (8, 16, 8, 4),                  # shares of 4 pages of 8 at least
    (8, 1000, 1, 8)])
def test_cluster_blocks_launch_no_block_a_slot_cannot_use(clusters, P, page,
                                                         want):
    """The cluster launched for a split of C is as wide as a slot of the
    table's P pages can have shares of 32 tokens, at most C."""
    assert torch_cuda.paged_attention.cluster_blocks(clusters, P,
                                                     page) == want


def test_kernel_times_cases_are_phase_2s():
    """The paged-decode cases chip_smoke and the timing of other
    checkouts share: table widths 1, 8 and 64 (lengths 1, full and
    seeded draws in [1, full]), GQA, bf16, and 8 slots at 600."""
    gen = torch.Generator()
    gen.manual_seed(0)
    cases = kernel_times.paged_cases(gen)
    f32, bf16 = torch.float32, torch.bfloat16
    assert [(c[0], c[1], c[2], c[3], c[4]) for c in cases] == [
        ("mha", 14, 14, 1, f32), ("mha", 14, 14, 8, f32),
        ("mha", 14, 14, 64, f32), ("gqa", 16, 4, 8, f32),
        ("mha", 14, 14, 64, bf16), ("anatomy", 14, 14, 64, f32)]
    for _, _, _, P, _, lens in cases:
        full = P * kernel_times.PAGE
        assert len(lens) == kernel_times.SLOTS
        assert all(1 <= n <= full for n in lens)
    for _, _, _, P, _, lens in cases[:3]:
        assert lens[:2] == [1, P * kernel_times.PAGE]
    assert cases[-1][-1] == [600] * kernel_times.SLOTS


def test_kernel_times_inputs_give_each_slot_its_own_pages():
    """Each slot's table rows name distinct pages of the pool, never page
    0, as the engine allocates them; q and the pools in the case's
    dtype, the plain version finite on them."""
    gen = torch.Generator()
    gen.manual_seed(0)
    S = kernel_times.SLOTS
    q, k, v, table, lengths = kernel_times.paged_inputs(
        gen, 4, 2, 8, torch.bfloat16, list(range(1, S + 1)), layers=2,
        num_pages=S * 8 + 1)
    assert q.shape == (S, 4, kernel_times.HEAD_DIM) and q.dtype == k.dtype \
        == v.dtype == torch.bfloat16
    assert k.shape == (2, S * 8 + 1, kernel_times.PAGE, 2,
                       kernel_times.HEAD_DIM) == v.shape
    assert table.shape == (S, 8) and table.dtype == torch.int32
    assert sorted(table.flatten().tolist()) == list(range(1, S * 8 + 1))
    assert lengths.tolist() == list(range(1, S + 1))
    out = torch_attention.paged_attention_reference(q, k, v, table, lengths,
                                                    layer=1)
    assert torch.isfinite(out.float()).all()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# split edges over a cluster of 8 (S x Hkv is small, so the grid stays
# resident at 8): page 8, a share at least 4 pages (32 tokens)
_SPLITS = {
    # 8 live pages: two shares of 4, the length on the second's end; 6:
    # shares of 4 and 2; 2: one share
    "rank_boundary": dict(P=16, lengths=(64, 48, 16)),
    "length_one_c8": dict(P=32, lengths=(1, 1, 1)),
    "ragged_pages": dict(P=32, lengths=(13, 77, 201)),
    "gqa_g8": dict(P=32, H=8, Hkv=1, lengths=(100, 5, 256)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_SPLITS))
def test_cuda_split_edges_match_plain_version(case):
    """A slot's live pages split over a cluster of blocks: lengths on a
    block boundary, a length of 1 over 8 blocks, lengths off the page,
    GQA with 8 query heads a KV head; against the plain version within
    2e-5 (f32 sums in another order)."""
    _cuda()
    c = _case(30, page=8, N=64, layers=2, **_SPLITS[case])
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    assert torch_cuda.paged_attention.clusters_for(t["q"], t["k"]) == 8
    got = torch_cuda.paged_attention_decode(
        t["q"], t["k"], t["v"], t["table"], t["lengths"], layer=1)
    ref = torch_attention.paged_attention_reference(
        t["q"], t["k"], t["v"], t["table"], t["lengths"], layer=1)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_cuda_split_is_bitwise_deterministic():
    """No atomics: at P 64, split over the wrapper's cluster, the partials
    merge in rank order, so two runs agree bit for bit (f32 and bf16)."""
    _cuda()
    c = _case(31, S=4, H=4, Hkv=4, page=16, P=64, N=300,
              lengths=(1024, 600, 1, 333))
    c["table"] = (np.arange(4 * 64, dtype=np.int32).reshape(4, 64) + 1)
    for dtype in (torch.float32, torch.bfloat16):
        t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
        q, k, v = (t[n].to(dtype) for n in ("q", "k", "v"))
        runs = [torch_cuda.paged_attention_decode(
            q, k, v, t["table"], t["lengths"]) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch_cuda.paged_attention.clusters_for(q, k) > 1
        assert torch.equal(runs[0], runs[1]), dtype


@pytest.mark.cuda
def test_cuda_split_length_zero_and_bad_page_in_the_last_share():
    """Over a cluster of 8: length 0 gives zeros, a bad page id among the
    last block's pages gives NaN for that slot only, the others agree
    with the plain version."""
    _cuda()
    c = _case(32, page=8, P=32, N=64, lengths=(0, 256, 256))
    c["table"][2, 31] = 64                    # N = 64: one past the pool
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    assert torch_cuda.paged_attention.clusters_for(t["q"], t["k"]) == 8
    got = torch_cuda.paged_attention_decode(t["q"], t["k"], t["v"],
                                            t["table"], t["lengths"])
    ref = torch_attention.paged_attention_reference(
        t["q"], t["k"], t["v"], t["table"].clamp(max=63), t["lengths"])
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0
    assert (got[1] - ref[1]).abs().max().item() <= 2e-5
    assert torch.isnan(got[2]).all()


@pytest.mark.cuda
def test_cuda_slot_result_does_not_depend_on_the_batch():
    """A slot's split depends on its own length and the engine's shape
    only: slot 0 at the same length and pages gives the same bits at
    table widths 64 and 8, beside other slots of other lengths (f32 and
    bf16)."""
    _cuda()
    c = _case(33, S=4, H=4, Hkv=4, page=16, P=64, N=300,
              lengths=(100, 1024, 600, 333))
    c["table"] = (np.arange(4 * 64, dtype=np.int32).reshape(4, 64) + 1)
    for dtype in (torch.float32, torch.bfloat16):
        t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
        q, k, v = (t[n].to(dtype) for n in ("q", "k", "v"))
        narrow = (t["table"][:, :8].contiguous(),
                  torch.tensor([100, 128, 5, 77], dtype=torch.int32,
                               device="cuda"))
        wide = torch_cuda.paged_attention_decode(q, k, v, t["table"],
                                                 t["lengths"])
        got = torch_cuda.paged_attention_decode(q, k, v, *narrow)
        ref = torch_attention.paged_attention_reference(q, k, v, *narrow)
        torch.cuda.synchronize()
        assert torch.equal(wide[0], got[0]), dtype
        tol = 2e-5 if dtype == torch.float32 else 1e-2
        assert (got.float() - ref.float()).abs().max().item() <= tol
