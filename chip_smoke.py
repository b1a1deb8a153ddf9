#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); it builds every
kernel from the sources in this checkout.  Phases, each fatal:

1. environment: card, power limit, versions, TF32 off, kernel build;
2. the paged-decode kernel against its plain PyTorch version on the
   card, at the shapes the serving path gives it, with times and bounds;
3. a small serving model on the card against the same model on the CPU,
   and the GPT ``760m`` widths (head dim 96) at 2 layers, served on the
   card by the plain paged attention (no kernel instance, no launch)
   against the CPU, then 4 requests through the engine;
4. full-width serving: ``PagedDecoderLM`` at the GPT ``1b`` widths of
   ``bench.py`` (vocab 50257, hidden 1792, 24 layers, 14 heads, ffn
   7168; random weights from a seed) behind ``GenerationEngine`` and
   ``ServingServer``, answering 16 ``/generate`` requests over HTTP;
5. anatomy of one full-width decode step (8 slots at context 600): its
   time on the host's clock, and the card's busy time by kernel from
   ``torch.profiler``;
6. the three flash-attention kernels (forward, dQ, dK/dV) against their
   plain versions through the autograd Function: every head dim (32,
   64, 96, 128), f32 and bf16, causal and not, dropout 0 and 0.1, at
   BERT-base's attention shape (D 64) and smaller ones, the GPT shapes
   and a ragged case; the dropout mask's kept fraction; times beside the
   bound, the plain version and one SDPA call at BERT-base's shape
   (bf16), the GPT 760m preset's (D 96, bf16) and the static step's
   (f32, against SDPA's memory-efficient backend); the f32 backward
   bitwise across two runs, and the kernels SDPA's f32 path runs, by
   name;
7. a small BERT (``bench_bert``'s CPU widths, f32, dropout 0) trained 3
   ``TrainStep``s on the card and on the CPU from the same weights;
8. full-width training: ``bench_bert``'s chip config (BERT-base, batch
   64, seq 512, dropout 0.1, O2 bf16 with f32 master weights, AdamW,
   global-norm clip) for 2 warm-up and 10 timed steps;
9. anatomy of one training step from ``torch.profiler``;
10. the fused matmul-epilogue kernels (forward; backward as two
    launches) against their plain versions at the three chains of a
    BERT-base layer (M 8192), f32 and bf16, three small recipes, and
    layer_norm recipes at N 640, 1152 and 1536 (the f32 forward's
    clusters of 5, 9 and 12 blocks), two backward runs bit for bit; the
    f32 forward with a zero bias bit for bit against K6's f32 product;
    the f32 backward's g with bias + relu bit for bit dy where the
    forward's output is positive; the fused Adam kernel against
    its plain version over the static BERT's parameters for 5 steps;
    times beside the bound, the plain version and a library call where
    one computes the same function;
11. a small static BERT (``bench.build_bert_static`` at bench_pallas's
    CPU widths) trained 3 ``Executor.run``s on the card and on the CPU
    from the same weights;
12. the full-width static BERT (bench_pallas's chip config: BERT-base,
    seq 512, batch 16, f32, Adam) through ``static.Executor``: 2 warm-up
    and 8 timed runs, asserting every kernel's launches per step;
13. anatomy of one static training step from ``torch.profiler``, its
    f32 kernels named with their launches a step;
14. the chunk matmul kernel (K6) against its plain version at the chunk
    shapes of the full-width hybrid step, three ragged shapes at the
    gate's edges (M 8, M 1000, K 96) and a row-strided x written into a
    column block of a wider out, f32 and bf16; its column blocks bitwise
    equal to K6 on the whole weight; times of one layer's six products
    beside the bound, the plain version and ``torch.matmul``;
15. the flash kernels through ``flash_attention_block``, forward and
    backward with a nonzero lse cotangent, at the ring's four offset
    cases (diagonal, visible, fully masked, non-causal), f32 and bf16,
    at every head dim;
    the ring's rounds and merges composed over 2 and 4 virtual shards
    against ``flash_attention`` on the whole sequence; times;
16. one rank over a process group with gloo (CPU) and NCCL (card): the
    small hybrid GPT trained 3 ``SpmdTrainStep``s on the card and on the
    CPU from the same weights;
17. the hybrid GPT at the ``1b`` widths (bench.py:318; batch 8, seq
    1024, dropout 0.1, O2 bf16, AdamW, global-norm clip) at world size
    1 over NCCL: 2 warm-up and 8 timed steps asserting 144 K6 launches
    and 24 of each flash kernel (block entry) a step, then its anatomy;
18. with two cards or more, NCCL ranks on {"mp": 2, "sp": n / 2} train
    2 layers at the ``1b`` widths against a world-size-1 run; on one
    card it prints that it did not run and why.

The last lines are the kernels JSON object, the card's name and power
limit as ``nvidia-smi`` reports them, and ``{"ok": true, ...}``.  Any
failure prints a traceback and exits 1 without the result line.
"""
import json
import math
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_OPS = {"float32": 67e12,       # CUDA-core f32
            "bfloat16": 989e12}     # dense tensor-core bf16
GPT_1B = dict(vocab_size=50257, hidden=1792, num_layers=24, num_heads=14,
              ffn=7168)
PAGE, SLOTS, MAX_CONTEXT = 16, 8, 1024
PROMPT_BUCKETS = [32, 64, 128, 256, 512]
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# bench.py:159-168, bench_bert's chip and CPU configurations
BERT_CHIP = dict(vocab=30522, hidden=768, layers=12, heads=12, ffn=3072,
                 seq=512, batch=64, dropout=0.1)
BERT_CPU = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512,
                seq=128, batch=8, dropout=0.0)
FLASH = "paddle_tpu/ops/pallas/flash_attention.py"
FLASH_KERNELS = {"flash_attention_fwd": f"{FLASH}:128",      # _fwd_kernel
                 "flash_attention_bwd_dq": f"{FLASH}:220",   # _bwd_dq_kernel
                 "flash_attention_bwd_dkv": f"{FLASH}:255"}  # _bwd_dkv_kernel
# kernel vs plain, as max |a - b| / max(1, max |b|): f32 sums taken in
# another order; bf16 probabilities and dS rounded to bf16 before the
# tensor-core products (the TPU kernel rounds them the same way)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# small BERT, card vs CPU, after 3 AdamW steps at lr 1e-4: Adam's step
# is lr * m / (sqrt(v) + eps), so the two sides agree to lr times the
# gradients' relative difference (f32 sums in other orders); 2e-5 is a
# fifth of one step.  The key projections' biases are held apart: their
# gradient is zero but for rounding (softmax ignores a shift shared by
# every key), so Adam moves them by up to lr a step on either side
BERT_PARAM_ATOL = 2e-5
# bench.py:1108-1109 and :1114-1115, bench_pallas's static BERT
STATIC_CHIP = dict(vocab=30522, hidden=768, layers=12, heads=12, ffn=3072,
                   seq=512, batch=16)
STATIC_CPU = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512,
                  seq=128, batch=8)
EPI = "paddle_tpu/ops/pallas/fused_epilogue.py"
EPI_KERNELS = {"fused_epilogue_fwd": f"{EPI}:195",         # _fwd
               "fused_epilogue_bwd": f"{EPI}:284",         # _bwd_call
               "fused_epilogue_bwd_grads": f"{EPI}:284"}
EPI_LIBRARY_CALLS = {
    "fused_epilogue_fwd": "torch._addmm_activation(bias, x, w, "
                          "use_gelu=True), fc1 chain only",
    "fused_epilogue_bwd": "torch.matmul(x, w): the product only",
    "fused_epilogue_bwd_grads": "torch.matmul(g, w.t()) + "
                                "torch.matmul(x.t(), g)"}
ADAM_SITE = "paddle_tpu/ops/pallas/fused_adam.py:65"     # fused_adam_update
# kernel vs plain, as max |a - b| / max(1, max |b|): f32 products and
# row sums taken in another order (K up to 3072, dw over 8192 rows);
# bf16 outputs and g rounded to bf16 on both sides, one rounding apart
EPI_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ADAM_TOL = 1e-6
# per static step at BERT-base: 3 fused chains a layer, one flash call a
# layer, one Adam launch
ROOT = os.path.dirname(os.path.abspath(__file__))
# bench.py:318-319 (_GPT_PRESETS["1b"]) at batch 8, and the tests' small
# widths of the same model
GPT_TRAIN = dict(vocab=50257, hidden=1792, layers=24, heads=14, ffn=7168,
                 seq=1024, batch=8, dropout=0.1)
# bench.py:317 (_GPT_PRESETS["760m"]): head dim 96
GPT_760M = dict(vocab=50257, hidden=1536, layers=24, heads=16, ffn=6144,
                seq=1024, dropout=0.1)
GPT_SMALL = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512,
                 seq=64, batch=4, dropout=0.0)
CMM_SITE = "paddle_tpu/ops/pallas/collective_matmul.py:44"  # _mm_kernel
# K6 vs plain, as max |a - b| / max(1, max |b|), outputs ~N(0, 1): f32
# sums over K taken in another order; bf16 rounded once on either side
CMM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# per hybrid GPT step at world size 1: six chunk products a layer (q, k,
# v, proj, fc1, fc2) and one attention call a layer
GPT_PER_STEP = {"chunk_matmul": 144, "flash_attention_fwd": 24,
                "flash_attention_bwd_dq": 24, "flash_attention_bwd_dkv": 24}
STATIC_PER_STEP = {"fused_epilogue_fwd": 36, "fused_epilogue_bwd": 36,
                   "fused_epilogue_bwd_grads": 36, "fused_adam": 1,
                   "flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
                   "flash_attention_bwd_dkv": 12}


def log(*a):
    print(*a, flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_name(key):
    """A flash or fused-epilogue kernel's name in a profiler key (mangled
    or not), without namespace, template arguments and parameters."""
    import re
    m = re.search(r"(flash_(fwd|bwd_dq|bwd_dkv)(_wgmma|_f32)?|"
                  r"epilogue_\w*?)_kernel", key)
    return m.group(0) if m else key[:80]


def _assert_wgmma_flash(flash):
    """A bf16 step's flash launches ran the wgmma + TMA kernels: the
    profiler names these three and no other flash kernel."""
    names = sorted(flash)
    want = ["flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
            "flash_fwd_wgmma_kernel"]
    if names != want:
        raise AssertionError(f"flash kernels seen {names}, want {want}")


# ---------------------------------------------------------------- phase 1
def phase_environment():
    import torch
    from paddle_tpu_torch.ops.cuda import support
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    support.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [l.strip() for l in support.build_info["nvcc_log"].splitlines()
             if "registers" in l or "spill" in l]
    for line in ptxas:
        log("ptxas:", line)
    env = {"nvidia_smi": nvidia_smi(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
           "kernel_build_s": round(build_s, 3),
           "nvcc_s": round(support.build_info["build_seconds"], 3)}
    log("ENV " + json.dumps(env))


# ---------------------------------------------------------------- phase 2
def _paged_case(torch, gen, S, H, Hkv, D, P, L, N, dtype, lengths):
    dev = "cuda"
    q = torch.randn((S, H, D), generator=gen, device=dev)
    k = torch.randn((L, N, PAGE, Hkv, D), generator=gen, device=dev)
    v = torch.randn((L, N, PAGE, Hkv, D), generator=gen, device=dev)
    # each slot owns distinct physical pages, as the engine allocates
    perm = torch.randperm(N - 1, generator=gen, device=dev)[:S * P] + 1
    table = perm.reshape(S, P).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q.to(dtype), k.to(dtype), v.to(dtype), table, lens)


def _paged_bound(S, H, Hkv, D, lengths, es, dtype_name):
    live = sum(lengths)
    pages = sum(-(-n // PAGE) for n in lengths)
    nbytes = (2 * S * H * D * es            # q in, out
              + live * Hkv * D * 2 * es     # live K and V rows
              + pages * 4 + S * 4)          # live table entries, lengths
    ops = 4 * live * H * D                  # q.k and p.v multiply-adds
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def phase_kernels():
    """paged_attention_decode vs paged_attention_reference on the card."""
    import torch
    from paddle_tpu_torch.ops.attention import paged_attention_reference
    from paddle_tpu_torch.ops.cuda import paged_attention_decode
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    L, N = GPT_1B["num_layers"], SLOTS * (MAX_CONTEXT // PAGE) + 1
    cases = []
    for P in (1, 8, 64):
        full = P * PAGE
        lens = [1, full] + [int(x) for x in torch.randint(
            1, full + 1, (SLOTS - 2,), generator=gen, device="cuda")]
        cases.append(("mha", 14, 14, P, torch.float32, lens))
    cases.append(("gqa", 16, 4, 8, torch.float32,
                  [1, 128, 77, 3, 64, 100, 17, 128]))
    cases.append(("mha", 14, 14, 64, torch.bfloat16,
                  [1, 1024, 700, 512, 33, 999, 256, 640]))
    results = []
    for label, H, Hkv, P, dtype, lens in cases:
        D = 128
        q, k, v, table, lengths = _paged_case(torch, gen, SLOTS, H, Hkv, D,
                                              P, L, N, dtype, lens)
        scale = 1.0 / math.sqrt(D)
        err = 0.0
        for layer in (0, L // 2, L - 1):
            got = paged_attention_decode(q, k, v, table, lengths,
                                         scale=scale, layer=layer)
            ref = paged_attention_reference(q, k, v, table, lengths,
                                            scale=scale, layer=layer)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{label} P={P}: non-finite output")
            err = max(err, (got.float() - ref.float()).abs().max().item())
        dname = str(dtype).replace("torch.", "")
        if not err <= TOL[dname]:
            raise AssertionError(f"paged_attention {label} P={P} {dname}: "
                                 f"max abs err {err} > {TOL[dname]}")
        # cycle through the layers so consecutive launches read other
        # memory, as the decode step's 24 calls do
        ms = cuda_ms(lambda i: paged_attention_decode(
            q, k, v, table, lengths, scale=scale, layer=i % L), 48)
        plain_ms = cuda_ms(lambda i: paged_attention_reference(
            q, k, v, table, lengths, scale=scale, layer=i % L), 12)
        bound_ms, bound_by, nbytes = _paged_bound(
            SLOTS, H, Hkv, D, lens, q.element_size(), dname)
        row = {"case": f"{label} S={SLOTS} H={H} Hkv={Hkv} D={D} "
                       f"page={PAGE} P={P} L={L} {dname}",
               "lengths": lens, "max_abs_err": err, "tol": TOL[dname],
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes,
               "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
               "library_ms": None}
        log("KERNEL " + json.dumps(row))
        results.append(row)
        del q, k, v, table, lengths
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phase 3
def _card_vs_cpu_logits(torch, geom, head_dim):
    """The same PagedDecoderLM (weights from the CPU copy) on the card
    and on the CPU: prefill of 37 tokens and three decode steps; the
    logits of every call, as f32 CPU tensors, per device."""
    from paddle_tpu_torch.serving import KVCacheConfig, PagedDecoderLM
    from paddle_tpu_torch.serving.kv_cache import PagePool
    cpu = PagedDecoderLM(device="cpu", **geom)
    gpu = PagedDecoderLM(device="cuda", **geom)
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    outs = {}
    for dev, lm in (("cpu", cpu), ("cuda", gpu)):
        cfg = KVCacheConfig(geom["num_layers"], geom["num_kv_heads"],
                            head_dim, page_size=PAGE, num_pages=16,
                            max_context=128)
        kv = PagePool(cfg, device=dev).kv
        toks = (torch.arange(40, dtype=torch.int32, device=dev) * 7
                % geom["vocab_size"])
        table = torch.arange(1, 9, dtype=torch.int32, device=dev)
        logits, _ = lm.prefill(toks, 37, kv, table)
        seq = [logits]
        tables = torch.stack([table, table * 0]).contiguous()
        for pos in (37, 38, 39):
            tok = torch.tensor([pos * 3, 0], dtype=torch.int32, device=dev)
            positions = torch.tensor([pos, 0], dtype=torch.int32,
                                     device=dev)
            logits, _ = lm.decode(tok, positions, kv, tables)
            seq.append(logits[0])
        outs[dev] = [t.float().cpu() for t in seq]
    return outs, gpu


def phase_small_model_parity():
    """The same small model (head_dim 128, GQA 4/2) on the card and on
    the CPU: prefill and three decode steps, logits rtol/atol 1e-4 (f32
    products summed in other orders by cuBLAS, the kernel and the CPU).
    Then the GPT 760m preset's widths (bench.py:317: vocab 50257, hidden
    1536, 16 heads of 96, ffn 6144) at 2 layers: no paged-decode kernel
    is built for head dim 96, so the gate serves it by the plain version
    on the card, as the JAX package's gate serves it by its reference:
    card vs CPU logits (max |a - b| / max(1, max |b|) <= 1e-4), then 4
    requests through GenerationEngine on the card, every one finished,
    with no paged_attention launch."""
    import torch
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.serving import GenerationEngine
    outs, _ = _card_vs_cpu_logits(torch, dict(
        vocab_size=512, hidden=512, num_layers=2, num_heads=4,
        num_kv_heads=2, seed=5), 128)
    err = max((a - b).abs().max().item()
              for a, b in zip(outs["cpu"], outs["cuda"]))
    for a, b in zip(outs["cpu"], outs["cuda"]):
        if not torch.allclose(b, a, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"small model: card vs CPU err {err}")
    geom = dict(vocab_size=GPT_760M["vocab"], hidden=GPT_760M["hidden"],
                num_layers=2, num_heads=GPT_760M["heads"],
                num_kv_heads=GPT_760M["heads"], ffn=GPT_760M["ffn"], seed=7)
    support.reset_launch_counts()
    outs, gpu = _card_vs_cpu_logits(torch, geom, 96)
    err96 = max(((a - b).abs().max() / a.abs().max().clamp_min(1.0)).item()
                for a, b in zip(outs["cpu"], outs["cuda"]))
    if not err96 <= 1e-4:
        raise AssertionError(f"760m widths: card vs CPU err {err96}")
    eng = GenerationEngine(gpu, num_slots=4, page_size=PAGE,
                           max_context=256, prompt_buckets=[64],
                           device="cuda")
    try:
        rng = __import__("numpy").random.RandomState(96)
        reqs = [dict(prompt=rng.randint(0, geom["vocab_size"],
                                        int(rng.randint(8, 65))).tolist(),
                     max_new_tokens=12, seed=i) for i in range(4)]
        streams = [eng.generate(**r) for r in reqs]
        toks = [st.result(600) for st in streams]
    finally:
        eng.close()
    launches = support.launch_counts.get("paged_attention", 0)
    if any(len(t) != r["max_new_tokens"] for t, r in zip(toks, reqs)):
        raise AssertionError(f"760m widths: tokens {[len(t) for t in toks]}")
    if launches != 0:
        raise AssertionError(f"760m widths (head dim 96): {launches} "
                             f"paged_attention launches, want 0")
    log("PARITY " + json.dumps({
        "small_model_max_abs_err": err, "rtol": 1e-4, "atol": 1e-4,
        "gpt_760m_2_layers_max_rel_err": err96, "rel_tol": 1e-4,
        "gpt_760m_2_layers_requests_finished": len(toks),
        "gpt_760m_2_layers_paged_attention_launches": launches}))
    del gpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def _requests():
    import numpy as np
    rng = np.random.RandomState(1234)
    reqs = []
    for i in range(16):
        n = int(rng.randint(16, 513))
        reqs.append(dict(prompt=rng.randint(0, GPT_1B["vocab_size"],
                                            n).tolist(),
                         max_new_tokens=int(rng.randint(32, 65)),
                         temperature=0.8 if i % 4 == 3 else 0.0,
                         seed=1000 + i))
    return reqs


def phase_serving():
    import torch
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.serving import (Client, GenerationEngine,
                                          PagedDecoderLM, ServingServer)
    t0 = time.perf_counter()
    model = PagedDecoderLM(seed=0, device="cuda", **GPT_1B)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    eng = GenerationEngine(model, num_slots=SLOTS, page_size=PAGE,
                           max_context=MAX_CONTEXT,
                           prompt_buckets=PROMPT_BUCKETS, device="cuda")
    srv = None
    try:
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.warmup()
        warmup_s = time.perf_counter() - t0
        srv = ServingServer(eng, port=0).start()
        reqs = _requests()
        results = [None] * len(reqs)
        errors = []

        def run(i):
            try:
                with Client(srv.url, timeout=600) as c:
                    r = reqs[i]
                    results[i] = (list(c.generate_stream(**r)) if i % 2
                                  else c.generate(**r))
            except BaseException as e:     # noqa: BLE001 - re-raised below
                errors.append(e)

        steps0 = eng.stats()["counters"]["decode_steps"]
        support.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall_s = time.perf_counter() - t0
        if errors:
            raise errors[0]
        # batch independence: a greedy prompt alone gives the tokens it
        # got inside the batch
        solo_i = 0
        with Client(srv.url, timeout=600) as c:
            solo = c.generate(**reqs[solo_i])
        launches = support.launch_counts.get("paged_attention", 0)
        st = eng.stats()
        steps = st["counters"]["decode_steps"] - steps0
    finally:
        if srv is not None:
            srv.close()
        eng.close()
    for i, (r, toks) in enumerate(zip(reqs, results)):
        if toks is None or len(toks) != r["max_new_tokens"]:
            raise AssertionError(f"request {i}: {None if toks is None else len(toks)} "
                                 f"tokens, wanted {r['max_new_tokens']}")
        if not all(0 <= t < GPT_1B["vocab_size"] for t in toks):
            raise AssertionError(f"request {i}: token out of range")
    if solo != results[solo_i]:
        raise AssertionError("greedy tokens differ alone and in the batch")
    if st["page_pool"]["in_use"] != 0:
        raise AssertionError(f"page pool did not drain: {st['page_pool']}")
    if launches != steps * GPT_1B["num_layers"]:
        raise AssertionError(f"paged_attention launched {launches} times "
                             f"in {steps} decode steps (want "
                             f"{steps * GPT_1B['num_layers']})")
    if st["recompiles_after_warmup"] != 0:
        raise AssertionError(f"variants after warmup: {st}")
    gen_tokens = sum(len(t) for t in results)
    out = {"params": n_params, "weight_bytes": weight_bytes,
           "model_setup_s": setup_s, "warmup_s": warmup_s,
           "requests": len(reqs), "greedy": sum(r["temperature"] == 0
                                                for r in reqs),
           "prompt_tokens": sum(len(r["prompt"]) for r in reqs),
           "generated_tokens": gen_tokens, "wall_s": wall_s,
           "tokens_per_s": gen_tokens / wall_s,
           "decode_steps": steps, "kernel_launches": launches,
           "step_ms_p50": st["step_ms"]["p50"],
           "step_ms_p99": st["step_ms"]["p99"],
           "step_ms_mean": st["step_ms"]["mean"],
           "ttft_ms_p50": st["ttft_ms"]["p50"],
           "ttft_ms_p99": st["ttft_ms"]["p99"],
           "mean_slot_occupancy": st["mean_slot_occupancy"],
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "batch_independent": True}
    log("SERVING " + json.dumps(out))
    return launches, model, eng.page_pool.kv


# ---------------------------------------------------------------- phase 5
def phase_anatomy(model, kv):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    S, P, ctx, steps = SLOTS, 64, 600, 5
    tables = (torch.arange(S * P, dtype=torch.int32, device="cuda")
              .reshape(S, P) + 1)
    toks = torch.arange(S, dtype=torch.int32, device="cuda") * 11
    pos = torch.full((S,), ctx, dtype=torch.int32, device="cuda")
    step_ms = cuda_ms(lambda i: model.decode(toks, pos, kv, tables), 20)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model.decode(toks, pos, kv, tables)
        torch.cuda.synchronize()
    groups = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        name = e.key.lower()
        g = ("paged_attention" if "paged_decode" in name else
             "gemm" if "gemm" in name or "splitk" in name else "other")
        groups[g] += e.self_device_time_total / 1e3 / steps
    busy = sum(groups.values())
    if not busy > 0:
        raise AssertionError("the profiler saw no device time")
    out = {"slots": S, "context": ctx, "table_pages": P,
           "step_ms_host": step_ms, "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1.0 - busy / step_ms),
           "device_ms_by_group": groups}
    log("ANATOMY " + json.dumps(out))


# ---------------------------------------------------------------- phase 6
def _flash_bound(B, H, Lq, Lk, D, es, dtype_name, causal, kernel):
    """Least time for one flash kernel: each input read once, each
    output written once; the tensor-core products over the visible
    (query, key) pairs (2 D operations per pair and product)."""
    if causal:
        pairs = sum(min(Lk, i + 1) for i in range(Lq))
    else:
        pairs = Lq * Lk
    q_bytes, k_bytes = B * H * Lq * D * es, B * H * Lk * D * es
    row_bytes = B * H * Lq * 4                   # lse or delta, f32
    nbytes, products = {
        # q k v -> out lse
        "flash_attention_fwd": (2 * q_bytes + 2 * k_bytes + row_bytes, 2),
        # q k v do lse delta -> dq: S, dP, dQ
        "flash_attention_bwd_dq": (3 * q_bytes + 2 * k_bytes
                                   + 2 * row_bytes, 3),
        # q k v do lse delta -> dk dv: S, dP, dV, dK
        "flash_attention_bwd_dkv": (2 * q_bytes + 4 * k_bytes
                                    + 2 * row_bytes, 4),
    }[kernel]
    ops = 2 * D * pairs * B * H * products
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def _flash_case(torch, gen, B, L, H, D, dtype, causal, p, seed, plain_b):
    """Forward and the three gradients through the autograd Function on
    the card, against the plain versions on the first ``plain_b``
    batch rows; errors as max |a - b| / max(1, max |b|)."""
    from paddle_tpu_torch.ops.cuda import flash_attention_fwd
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference_bwd,
        flash_attention_reference_fwd)
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    scale = 1.0 / math.sqrt(D)
    out = flash_attention(qg, kg, vg, causal=causal, dropout_p=p, seed=seed)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    _, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                 dropout_p=p, seed=seed)
    torch.cuda.synchronize()
    t = lambda x: x[:plain_b].transpose(1, 2)            # noqa: E731
    kw = dict(causal=causal, scale=scale, dropout_p=p, seed=seed)
    ro, rlse = flash_attention_reference_fwd(t(q), t(k), t(v), **kw)
    refs = flash_attention_reference_bwd(t(q), t(k), t(v), ro, rlse, t(do),
                                         **kw)
    errs = {}
    for name, got, ref in [("out", t(out), ro), ("lse", lse[:plain_b], rlse),
                           ("dq", t(grads[0]), refs[0]),
                           ("dk", t(grads[1]), refs[1]),
                           ("dv", t(grads[2]), refs[2])]:
        got, ref = got.float(), ref.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash {name}: non-finite values")
        errs[name] = ((got - ref).abs().max()
                      / ref.abs().max().clamp_min(1.0)).item()
    return errs


def _sdpa_ms(torch, q, k, v, do, p, causal, backend=None):
    """One PyTorch SDPA backend (flash by default; the memory-efficient
    one for f32, which flash refuses) on the same inputs ([B, H, L, D]
    copies): ms of the forward, of one autograd backward (dq, dk, dv
    together), and of forward + backward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    with sdpa_kernel(backend or SDPBackend.FLASH_ATTENTION):
        fwd = cuda_ms(lambda i: sdpa(qt, kt, vt, dropout_p=p,
                                     is_causal=causal), 20)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        out = sdpa(qg, kg, vg, dropout_p=p, is_causal=causal)
        bwd = cuda_ms(lambda i: torch.autograd.grad(
            out, (qg, kg, vg), dot, retain_graph=True), 20)
        both = cuda_ms(lambda i: torch.autograd.grad(
            sdpa(qg, kg, vg, dropout_p=p, is_causal=causal), (qg, kg, vg),
            dot), 20)
    return fwd, bwd, both


def _flash_time_rows(torch, gen, B, L, H, D, dtype, causal, p, seed,
                     entry="flash_attention"):
    """The three flash kernels timed at one shape, each beside its bound,
    the plain version and one SDPA call (flash backend at bf16, the
    memory-efficient one at f32): {kernel: row}."""
    from torch.nn.attention import SDPBackend
    from paddle_tpu_torch.ops.cuda import (flash_attention_bwd_dkv,
                                           flash_attention_bwd_dq,
                                           flash_attention_fwd)
    from paddle_tpu_torch.ops.flash_attention import (
        attention_delta, flash_attention_reference_bwd,
        flash_attention_reference_fwd)
    dname = str(dtype).replace("torch.", "")
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    kw = dict(scale=scale, causal=causal, dropout_p=p)
    out, lse = flash_attention_fwd(q, k, v, seed=seed, **kw)
    delta = attention_delta(do.transpose(1, 2), out.transpose(1, 2))
    ms = {
        "flash_attention_fwd": cuda_ms(lambda i: flash_attention_fwd(
            q, k, v, seed=i, **kw), 20),
        "flash_attention_bwd_dq": cuda_ms(lambda i: flash_attention_bwd_dq(
            q, k, v, do, lse, delta, seed=seed, **kw), 20),
        "flash_attention_bwd_dkv": cuda_ms(
            lambda i: flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                              seed=seed, **kw), 20)}
    tq, tk, tv, tdo = (x.transpose(1, 2) for x in (q, k, v, do))
    pkw = dict(causal=causal, scale=scale, dropout_p=p, seed=seed)
    plain_fwd = cuda_ms(lambda i: flash_attention_reference_fwd(
        tq, tk, tv, **pkw), 2, warmup=1)
    plain_bwd = cuda_ms(lambda i: flash_attention_reference_bwd(
        tq, tk, tv, out.transpose(1, 2), lse, tdo, **pkw), 2, warmup=1)
    torch.cuda.empty_cache()
    f32 = dtype == torch.float32
    backend = SDPBackend.EFFICIENT_ATTENTION if f32 else None
    lib_fwd, lib_bwd, lib_both = _sdpa_ms(torch, q, k, v, do, p, causal,
                                          backend)
    lib_name = ("scaled_dot_product_attention, memory-efficient backend"
                if f32 else "scaled_dot_product_attention, flash backend")
    case = (f"B={B} L={L} H={H} D={D} {dname} causal={causal} "
            f"dropout={p}")
    rows = {}
    for name in FLASH_KERNELS:
        bound_ms, bound_by, nbytes, ops = _flash_bound(
            B, H, L, L, D, q.element_size(), dname, causal, name)
        fwd = name == "flash_attention_fwd"
        row = {"kernel": name, "entry": entry, "case": case,
               "ms": ms[name], "plain_ms": plain_fwd if fwd else plain_bwd,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "operations": ops,
               "library_ms": lib_fwd if fwd else lib_bwd,
               "library_call": lib_name if fwd else
               f"autograd backward of {lib_name} (dq, dk, dv together)",
               "library_fwd_bwd_ms": lib_both}
        if not fwd:
            row["plain_computes"] = "dq, dk and dv together"
        log("KERNEL " + json.dumps(row))
        rows[name] = row
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return rows


def _flash_f32_bitwise(torch, gen, B, L, H, D):
    """Two runs of the f32 backward kernels (dQ, dK/dV) agree bit for
    bit, with dropout, causal and not: no atomics, fixed sum orders."""
    from paddle_tpu_torch.ops.cuda import (flash_attention_bwd_dkv,
                                           flash_attention_bwd_dq,
                                           flash_attention_fwd)
    from paddle_tpu_torch.ops.flash_attention import attention_delta
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen, device="cuda")
                   for _ in range(4))
    out = {}
    for causal in (False, True):
        kw = dict(scale=1.0 / math.sqrt(D), causal=causal, dropout_p=0.1,
                  seed=7)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        delta = attention_delta(do.transpose(1, 2), o.transpose(1, 2))
        runs = [(flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                 *flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
                for _ in range(2)]
        torch.cuda.synchronize()
        out[f"causal={causal}"] = all(torch.equal(a, b)
                                      for a, b in zip(*runs))
    log("FLASH_F32_BITWISE " + json.dumps({
        "case": f"B={B} L={L} H={H} D={D} float32 dropout=0.1", **out}))
    if not all(out.values()):
        raise AssertionError(f"two f32 flash backward runs differ: {out}")


def _sdpa_f32_kernels(torch, gen, B, L, H, D):
    """The kernels SDPA's memory-efficient backend runs for one f32
    forward + backward, by name from the profiler (does its f32 run on
    the tensor cores, as 3xTF32?)."""
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do = (torch.randn((B, H, L, D), generator=gen, device="cuda")
                   for _ in range(4))
    qg, kg, vg = (x.requires_grad_() for x in (q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
        torch.autograd.grad(out, (qg, kg, vg), do)
        torch.cuda.synchronize()
    names = sorted({e.key[:160] for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA})
    log("SDPA_F32_KERNELS " + json.dumps({
        "case": f"B={B} L={L} H={H} D={D} float32", "kernels": names}))


def phase_flash_kernels():
    """The flash kernels against their plain versions on the card at
    every head dim they are built for (32, 64, 96, 128), f32 and bf16,
    causal and not, dropout 0 and 0.1; then timed at the training path's
    shape (BERT-base attention: B 64, H 12, L 512, D 64, bf16, dropout
    0.1, not causal), at the GPT 760m preset's (B 16, L 1024, H 16, D
    96, bf16, causal, dropout 0.1) and at the static BERT step's (B 16,
    L 512, H 12, D 64, f32)."""
    import torch
    from paddle_tpu_torch.core.rng import dropout_threshold
    from paddle_tpu_torch.ops.cuda.flash_attention import SUPPORTED_HEAD_DIMS
    from paddle_tpu_torch.ops.flash_attention import (dropout_keep_mask,
                                                      flash_attention)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, H, L = BERT_CHIP["batch"], BERT_CHIP["heads"], BERT_CHIP["seq"]
    D = BERT_CHIP["hidden"] // H
    seed = 1234
    # BERT-base's shape at its head dim, a smaller ragged one at the others
    cases = [(B, L, H, d, dt, causal, p, 8) if d == D else
             (4, 320, 6, d, dt, causal, p, 4)
             for d in SUPPORTED_HEAD_DIMS
             for dt in (torch.float32, torch.bfloat16)
             for causal in (False, True) for p in (0.0, 0.1)]
    cases += [(4, 512, 14, 128, torch.bfloat16, True, 0.1, 4),   # GPT 1b
              (2, 1024, 16, 96, torch.bfloat16, True, 0.1, 2),   # GPT 760m
              (3, 200, 5, 32, torch.float32, True, 0.1, 3),      # ragged
              (3, 200, 5, 32, torch.bfloat16, False, 0.1, 3)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for (b, l, h, d, dt, causal, p, plain_b) in cases:
        dname = str(dt).replace("torch.", "")
        errs = _flash_case(torch, gen, b, l, h, d, dt, causal, p, seed,
                           plain_b)
        err = max(errs.values())
        worst[dname] = max(worst[dname], err)
        row = {"case": f"B={b} L={l} H={h} D={d} {dname} causal={causal} "
                       f"dropout={p}", "errors": errs,
               "tol": FLASH_TOL[dname]}
        log("FLASH_CHECK " + json.dumps(row))
        if not err <= FLASH_TOL[dname]:
            raise AssertionError(f"flash kernels disagree with the plain "
                                 f"version: {row}")
    # the mask itself: kept fraction within 4 sigma of 1 - p, and two
    # seeds give other masks
    p = BERT_CHIP["dropout"]
    t, _ = dropout_threshold(p)
    keep = dropout_keep_mask(seed, 8, H, L, L, p, "cuda")
    other = dropout_keep_mask(seed + 1, 8, H, L, L, p, "cuda")
    n = keep.numel()
    kept = keep.float().mean().item()
    want = 1.0 - t / 65536.0
    sigma = math.sqrt(want * (1.0 - want) / n)
    differ = (keep != other).float().mean().item()
    mask = {"elements": n, "kept": kept, "expected": want, "sigma": sigma,
            "differ_across_seeds": differ}
    log("FLASH_MASK " + json.dumps(mask))
    if abs(kept - want) > 4 * sigma or differ < 0.1:
        raise AssertionError(f"dropout mask: {mask}")
    del keep, other
    # times at the training path's shape, forward + backward beside SDPA
    rows = _flash_time_rows(torch, gen, B, L, H, D, torch.bfloat16, False,
                            p, seed)
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    ours_both = cuda_ms(lambda i: torch.autograd.grad(
        flash_attention(qg, kg, vg, dropout_p=p, seed=i), (qg, kg, vg), do),
        20)
    log("FLASH_FWD_BWD " + json.dumps({
        "case": f"B={B} L={L} H={H} D={D} bfloat16 dropout={p}",
        "kernels_ms": ours_both,
        "sdpa_flash_ms": rows["flash_attention_fwd"]["library_fwd_bwd_ms"]}))
    del q, k, v, do, qg, kg, vg
    torch.cuda.empty_cache()
    g = GPT_760M
    d96 = _flash_time_rows(torch, gen, 16, g["seq"], g["heads"],
                           g["hidden"] // g["heads"], torch.bfloat16, True,
                           g["dropout"], seed)
    s = STATIC_CHIP
    static = _flash_time_rows(torch, gen, s["batch"], s["seq"], s["heads"],
                              s["hidden"] // s["heads"], torch.float32,
                              False, 0.0, seed)
    _flash_f32_bitwise(torch, gen, s["batch"], s["seq"], s["heads"],
                       s["hidden"] // s["heads"])
    _sdpa_f32_kernels(torch, gen, s["batch"], s["seq"], s["heads"],
                      s["hidden"] // s["heads"])
    for name, row in rows.items():
        row["max_abs_err"] = worst["float32"]
        row["max_abs_err_bf16"] = worst["bfloat16"]
        row["gpt_760m"] = d96[name]
        row["static_f32"] = static[name]
    return rows


# ---------------------------------------------------------------- phase 7
def _bert_trainer(torch, cfg, device, bf16):
    from paddle_tpu_torch import amp, jit, optimizer
    from paddle_tpu_torch.testing.models import build_model, mlm_loss
    model = build_model(cfg["vocab"], cfg["hidden"], cfg["layers"],
                        cfg["heads"], cfg["ffn"], cfg["seq"],
                        cfg["dropout"], device=device)
    opt = optimizer.AdamW(learning_rate=1e-4,
                          parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                          multi_precision=bf16)
    if bf16:
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model, jit.TrainStep(model, mlm_loss(model), opt, n_inputs=1,
                                donate=True)


def _bert_batch(torch, cfg, device):
    """bench.py:197-201: ids and labels from RandomState(0)."""
    import numpy as np
    rng = np.random.RandomState(0)
    shape = (cfg["batch"], cfg["seq"])
    x = rng.randint(0, cfg["vocab"], shape, dtype=np.int32)
    y = rng.randint(0, cfg["vocab"], shape, dtype=np.int32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def phase_small_bert_parity():
    """bench_bert's CPU config (f32, dropout 0) trained 3 steps on the
    card and on the CPU from the same weights: losses within rtol 1e-5,
    every parameter within BERT_PARAM_ATOL, and the flash kernels
    launched once per layer and step on the card."""
    import torch
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.ops.cuda import support
    cfg, steps = BERT_CPU, 3
    seed(7)
    cpu, cpu_step = _bert_trainer(torch, cfg, "cpu", False)
    gpu, gpu_step = _bert_trainer(torch, cfg, "cuda", False)
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    losses = {}
    for dev, step in (("cpu", cpu_step), ("cuda", gpu_step)):
        x, y = _bert_batch(torch, cfg, dev)
        support.reset_launch_counts()
        losses[dev] = [float(step(x, y)) for _ in range(steps)]
        counts = dict(support.launch_counts)
        if dev == "cuda":
            want = cfg["layers"] * steps
            if any(counts.get(n, 0) != want for n in FLASH_KERNELS):
                raise AssertionError(f"small BERT: launches {counts}, "
                                     f"want {want} of each flash kernel")
    gp = dict(gpu.named_parameters())
    diffs = {n: (gp[n].detach().cpu() - p.detach()).abs().max().item()
             for n, p in cpu.named_parameters()}
    k_bias = {n: d for n, d in diffs.items()
              if n.endswith("self_attn.k_proj.bias")}
    rest = {n: d for n, d in diffs.items() if n not in k_bias}
    worst = max(rest, key=rest.get)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    out = {"losses_cpu": losses["cpu"], "losses_cuda": losses["cuda"],
           "loss_max_rel_err": loss_err, "param_max_abs_err": rest[worst],
           "param_worst": worst, "k_proj_bias_max_abs_err":
           max(k_bias.values()), "loss_rtol": 1e-5,
           "param_atol": BERT_PARAM_ATOL, "k_proj_bias_atol": 2e-4 * steps}
    log("BERT_PARITY " + json.dumps(out))
    if (not loss_err <= 1e-5 or not rest[worst] <= BERT_PARAM_ATOL
            or not max(k_bias.values()) <= 2e-4 * steps):
        raise AssertionError(f"small BERT card vs CPU: {out}")


# ---------------------------------------------------------------- phase 8
def phase_bert_training(warmup=2, steps=10):
    """bench_bert's chip config on the card: every loss finite, the
    first near ln(vocab), each flash kernel launched 12 times a step."""
    import numpy as np
    import torch
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import bench_flops_per_step
    cfg = BERT_CHIP
    seed(2024)
    t0 = time.perf_counter()
    model, step = _bert_trainer(torch, cfg, "cuda", True)
    x, y = _bert_batch(torch, cfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    support.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = {n: support.launch_counts.get(n, 0) for n in FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[warmup:]
    flops = bench_flops_per_step(model, cfg["vocab"], cfg["hidden"],
                                 cfg["layers"], cfg["seq"], cfg["batch"])
    mean_ms = sum(timed) / len(timed)
    tokens = cfg["batch"] * cfg["seq"]
    out = {"config": cfg, "dtype": "bfloat16 O2, f32 master weights",
           "params": sum(p.numel() for p in model.parameters()),
           "setup_s": setup_s, "warmup_steps": warmup, "timed_steps": steps,
           "losses": losses, "step_ms": timed,
           "step_ms_p50": float(np.median(timed)), "step_ms_mean": mean_ms,
           "first_steps_ms": step_ms[:warmup],
           "tokens_per_s": tokens / (mean_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu": flops / (mean_ms / 1e3) / PEAK_OPS["bfloat16"],
           "peak_bound_ms": flops / PEAK_OPS["bfloat16"] * 1e3,
           "max_memory_allocated": peak, "flash_launches": counts}
    log("TRAIN " + json.dumps(out))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg["vocab"])) > 0.5:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg['vocab']}) = "
                             f"{math.log(cfg['vocab'])}")
    want = cfg["layers"] * (warmup + steps)
    if any(c != want for c in counts.values()):
        raise AssertionError(f"flash launches {counts}, want {want} each")
    return counts, model, step, (x, y)


# ---------------------------------------------------------------- phase 9
def _step_anatomy(tag, one_step, steps, classify, wgmma_flash=False):
    """One training step's anatomy: its time on the host clock (CUDA
    events over 3 steps), then ``torch.profiler`` over ``steps`` steps:
    device ms a step by ``classify``'s groups (a function of the lower-case
    kernel name), the flash kernels by name, the top kernels and the
    device's idle share.  With ``wgmma_flash`` the flash launches must
    have run the wgmma + TMA kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step_ms = cuda_ms(lambda i: one_step(), 3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    groups, top, flash, epi, launches = {}, [], {}, {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        name = e.key.lower()
        ms = e.self_device_time_total / 1e3 / steps
        g = classify(name)
        groups[g] = groups.get(g, 0.0) + ms
        top.append((ms, e.key[:80]))
        if "flash_" in name or "epilogue_" in name:
            k = _kernel_name(e.key)
            named = flash if "flash_" in name else epi
            named[k] = named.get(k, 0.0) + ms
            launches[k] = launches.get(k, 0) + e.count / steps
    busy = sum(groups.values())
    if not busy > 0:
        raise AssertionError("the profiler saw no device time")
    top.sort(reverse=True)
    out = {"step_ms_host": step_ms, "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1.0 - busy / step_ms),
           "device_ms_by_group": groups, "flash_kernels_ms": flash,
           "epilogue_kernels_ms": epi, "launches_per_step": launches,
           "top_kernels_ms": [[round(m, 4), n] for m, n in top[:24]]}
    log(tag + " " + json.dumps(out))
    if wgmma_flash:
        _assert_wgmma_flash(flash)
    return launches


def _is_gemm(name):
    return any(w in name for w in ("gemm", "xmma", "cutlass", "splitk",
                                   "nvjet"))


def phase_train_anatomy(step, batch, steps=2):
    x, y = batch
    _step_anatomy("TRAIN_ANATOMY", lambda: step(x, y), steps, lambda n: (
        "flash_fwd" if "flash_fwd_" in n else
        "flash_bwd" if "flash_bwd_" in n else
        "gemm" if _is_gemm(n) else "other"), wgmma_flash=True)


# --------------------------------------------------------------- phase 10
def _epi_chains(cfg):
    """The three fused chains of a BERT-base layer: (label, K, N,
    stages after the bias, residual?)."""
    h, f = cfg["hidden"], cfg["ffn"]
    ln = ("layer_norm", 1e-5, True, True)
    return [("proj", h, h, (("add",), ln)),
            ("fc1", h, f, (("gelu", True),)),
            ("fc2", f, h, (("add",), ln))]


def _epi_case(torch, gen, M, K, N, stages, dtype):
    """x, w and the operands (bias first, as fused_linear_epilogue lays
    them out) and dy, on the card."""
    from paddle_tpu_torch.ops.fused_epilogue import ops_per_stage
    r = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                   device="cuda")
    x = r(M, K)
    w = r(K, N) * math.sqrt(2.0 / (K + N))
    ops = [r(1, N) * 0.1]
    for st in stages:
        if st[0] == "add":
            ops.append(r(M, N))
        elif st[0] == "layer_norm":
            ops += [1.0 + 0.1 * r(1, N), 0.1 * r(1, N)][:ops_per_stage(st)]
    dy = r(M, N)
    return [t.to(dtype) for t in (x, w, dy)] + [[o.to(dtype) for o in ops]]


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise AssertionError("non-finite kernel output")
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1.0)).item()


def _epi_bounds(M, K, N, stages, es, dtype_name):
    """Least times of the three launches of one chain (each input read
    once, each output written once; the products' 2 M K N operations a
    product at the dtype's peak)."""
    n_res = sum(st[0] == "add" for st in stages)
    n_vec = 1 + sum(2 for st in stages if st[0] == "layer_norm")
    mk, kn, mn = M * K * es, K * N * es, M * N * es
    vec = n_vec * N * es
    ops1 = 2 * M * K * N
    launches = {
        # x w ops -> out
        "fused_epilogue_fwd": (mk + kn + vec + n_res * mn + mn, ops1),
        # x w dy ops -> g, d-residual, partial sums (one row per
        # 128-row block at f32)
        "fused_epilogue_bwd": (mk + kn + 2 * mn + vec + 2 * n_res * mn
                               + math.ceil(M / 128) * n_vec * N * 4, ops1),
        # x w g partials -> dx dw(f32) dvec
        "fused_epilogue_bwd_grads": (2 * mk + kn + mn + K * N * 4
                                     + math.ceil(M / 128) * n_vec * N * 4
                                     + n_vec * N * 4, 2 * ops1)}
    out = {}
    for name, (nbytes, ops) in launches.items():
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / PEAK_OPS[dtype_name] * 1e3
        out[name] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
                     nbytes, ops)
    return out


def _epi_check(torch, x, w, dy, ops, stages):
    """K2f and K2b against the plain versions on the same inputs: the
    error of each output."""
    from paddle_tpu_torch.ops.cuda import fused_epilogue as cuda_epi
    from paddle_tpu_torch.ops.fused_epilogue import (
        epilogue_backward_reference, epilogue_forward_reference)
    full = (("bias",),) + tuple(stages)
    out = cuda_epi.fused_epilogue_fwd(x, w, ops, full)
    dx, dw, dops = cuda_epi.fused_epilogue_bwd(x, w, ops, full, dy)
    torch.cuda.synchronize()
    ref = epilogue_forward_reference(x, w, ops, full)
    rdx, rdw, rdops = epilogue_backward_reference(x, w, ops, full, dy)
    errs = {"out": _rel_err(out, ref), "dx": _rel_err(dx, rdx),
            "dw": _rel_err(dw, rdw)}
    names = ["d_bias"]
    for st in stages:
        if st[0] == "add":
            names.append("d_residual")
        elif st[0] == "layer_norm":
            names += ["d_ln_weight", "d_ln_bias"]
    for name, a, b in zip(names, dops, rdops):
        errs[name] = _rel_err(a, b)
    # determinism: a second backward agrees bit for bit, g included
    dx2, dw2, dops2 = cuda_epi.fused_epilogue_bwd(x, w, ops, full, dy)
    g1 = cuda_epi.fused_epilogue_bwd_rows(x, w, ops, full, dy)[0]
    g2 = cuda_epi.fused_epilogue_bwd_rows(x, w, ops, full, dy)[0]
    same = (torch.equal(dx, dx2) and torch.equal(dw, dw2)
            and torch.equal(g1, g2)
            and all(torch.equal(a, b) for a, b in zip(dops, dops2)))
    if not same:
        raise AssertionError("two fused_epilogue_bwd runs differ")
    return errs


def _epi_relu_replay(torch, gen):
    """K2b at f32 replays K2f's accumulator bit for bit: with bias + relu
    its g is dy where K2f's output is positive and 0 elsewhere, exactly
    (ragged rows and depth, a cluster-free grid of 5 column blocks)."""
    from paddle_tpu_torch.ops.cuda import fused_epilogue as cuda_epi
    stages = (("bias",), ("relu",))
    x, w, dy, ops = _epi_case(torch, gen, 1000, 264, 640, (("relu",),),
                              torch.float32)
    out = cuda_epi.fused_epilogue_fwd(x, w, ops, stages)
    g, _, _ = cuda_epi.fused_epilogue_bwd_rows(x, w, ops, stages, dy)
    torch.cuda.synchronize()
    equal = torch.equal(g, torch.where(out > 0, dy, torch.zeros_like(dy)))
    log("EPILOGUE_RELU_REPLAY " + json.dumps({
        "case": "bias+relu M=1000 K=264 N=640 float32",
        "g_equals_dy_where_out_positive": equal}))
    if not equal:
        raise AssertionError("K2b's g differs from dy * (K2f's out > 0)")


def _epi_bitwise_k6(torch, gen, M):
    """K2f at f32 with a zero bias equals K6's f32 product bit for bit:
    both sum every element as one FMA chain over k in order (fc1's
    shape)."""
    from paddle_tpu_torch.ops.cuda import chunk_matmul as k6
    from paddle_tpu_torch.ops.cuda import fused_epilogue as cuda_epi
    K, N = STATIC_CHIP["hidden"], STATIC_CHIP["ffn"]
    x = torch.randn((M, K), generator=gen, device="cuda")
    w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
    zero = torch.zeros((1, N), device="cuda")
    out = cuda_epi.fused_epilogue_fwd(x, w, [zero], (("bias",),))
    ref = k6.chunk_matmul(x, w)
    torch.cuda.synchronize()
    equal = torch.equal(out, ref)
    log("EPILOGUE_BITWISE_K6 " + json.dumps({
        "case": f"bias 0, M={M} K={K} N={N} float32", "equal": equal}))
    if not equal:
        raise AssertionError("K2f f32 with a zero bias differs from K6's "
                             "f32 product")


def _static_param_shapes(cfg):
    """program.parameters() of build_bert_static, in order."""
    h, f, v = cfg["hidden"], cfg["ffn"], cfg["vocab"]
    layer = [(h, h), (h,)] * 4 + [(h,), (h,), (h, f), (f,), (f, h), (h,),
                                  (h,), (h,)]
    return [(v, h)] + layer * cfg["layers"] + [(h, v), (v,)]


def _adam_phase(torch, gen):
    """K3 over the full-width static BERT's parameters: 5 steps against
    the plain version, then times; torch._fused_adam_ timed beside it."""
    from paddle_tpu_torch.ops.fused_adam import (FusedAdam,
                                                 fused_adam_reference_)
    shapes = _static_param_shapes(STATIC_CHIP)
    numel = sum(math.prod(s) for s in shapes)
    ps = [torch.randn(s, generator=gen, device="cuda") * 0.02
          for s in shapes]
    sides = {}
    for side in ("kernel", "plain"):
        sides[side] = ([p.clone() for p in ps],
                       [torch.zeros_like(p) for p in ps],
                       [torch.zeros_like(p) for p in ps],
                       [torch.zeros_like(p) for p in ps])
    lr = torch.full((), 1e-4, device="cuda")
    step = torch.zeros((), device="cuda")
    kern = FusedAdam(*sides["kernel"])
    for _ in range(5):
        step += 1
        grads = [torch.randn(s, generator=gen, device="cuda")
                 for s in shapes]
        for side in ("kernel", "plain"):
            torch._foreach_copy_(sides[side][1], grads)
        kern(lr, step)
        fused_adam_reference_(*sides["plain"], lr, step)
    torch.cuda.synchronize()
    err = max(max((a - b).abs().max().item() for a, b in zip(la, lb))
              for la, lb in zip(sides["kernel"], sides["plain"]))
    if not err <= ADAM_TOL:
        raise AssertionError(f"fused_adam: max abs err {err} > {ADAM_TOL}")
    ms = cuda_ms(lambda i: kern(lr, step), 20)
    plain_ms = cuda_ms(lambda i: fused_adam_reference_(*sides["plain"], lr,
                                                        step), 5)
    lp, lg, lm, lv = sides["plain"]
    steps = [torch.full((), 6.0, device="cuda") for _ in lp]
    lib_ms = cuda_ms(lambda i: torch._fused_adam_(
        lp, lg, lm, lv, [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False), 20)
    nbytes = 28 * numel
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 15 * numel / PEAK_OPS["float32"] * 1e3
    row = {"kernel": "fused_adam", "tensors": len(shapes), "numel": numel,
           "max_abs_err": err, "tol": ADAM_TOL, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_b, t_o),
           "bound_by": "bytes" if t_b >= t_o else "operations",
           "bytes": nbytes, "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
           "library_ms": lib_ms,
           "library_call": "torch._fused_adam_ over the same lists"}
    log("KERNEL " + json.dumps(row))
    del sides, ps, grads, steps, kern
    torch.cuda.empty_cache()
    return row


def phase_epilogue_adam_kernels():
    """K2f and K2b against their plain versions: the three BERT-base
    chains at M 8192 in f32 and bf16, three small recipes (bias only,
    relu, gelu-erf) at a ragged shape, layer_norm recipes over clusters
    of 5, 9 and 12 blocks; K2f bitwise against K6 at f32; times of the
    f32 chains (the main path's dtype); then K3."""
    import torch
    from paddle_tpu_torch.ops.cuda import fused_epilogue as cuda_epi
    from paddle_tpu_torch.ops.fused_epilogue import (
        epilogue_backward_reference, epilogue_forward_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    M = STATIC_CHIP["batch"] * STATIC_CHIP["seq"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(label, M, K, N, st, dt)
             for label, K, N, st in _epi_chains(STATIC_CHIP)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(name, 200, 72, 256, st, dt)
              for name, st in (("bias_only", ()), ("relu", (("relu",),)),
                               ("gelu_erf", (("gelu", False),)))
              for dt in (torch.float32, torch.bfloat16)]
    # layer_norm rows joined over clusters of 5, 9 and 12 blocks (the f32
    # forward), at a depth off the 128 tile and rows off the 128 tile
    ln = ("layer_norm", 1e-5, True, True)
    cases += [(f"add+layer_norm cluster {n // 128}", 1000, 264, n,
               (("add",), ln), dt)
              for n in (640, 1152, 1536)
              for dt in (torch.float32, torch.bfloat16)]
    for label, m, k, n, stages, dt in cases:
        dname = str(dt).replace("torch.", "")
        x, w, dy, ops = _epi_case(torch, gen, m, k, n, stages, dt)
        errs = _epi_check(torch, x, w, dy, ops, stages)
        err = max(errs.values())
        worst[dname] = max(worst[dname], err)
        row = {"case": f"{label} M={m} K={k} N={n} {dname}",
               "errors": errs, "tol": EPI_TOL[dname]}
        log("EPILOGUE_CHECK " + json.dumps(row))
        if not err <= EPI_TOL[dname]:
            raise AssertionError(f"fused epilogue kernels disagree with "
                                 f"the plain versions: {row}")
        del x, w, dy, ops
    _epi_bitwise_k6(torch, gen, M)
    _epi_relu_replay(torch, gen)
    # times at the main path's shapes, f32
    rows = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes": 0, "operations": 0, "chains": {}}
            for name in EPI_KERNELS}
    for label, K, N, stages in _epi_chains(STATIC_CHIP):
        x, w, dy, ops = _epi_case(torch, gen, M, K, N, stages, torch.float32)
        full = (("bias",),) + tuple(stages)
        g, partial, _ = cuda_epi.fused_epilogue_bwd_rows(x, w, ops, full, dy)
        ms = {"fused_epilogue_fwd": cuda_ms(
                  lambda i: cuda_epi.fused_epilogue_fwd(x, w, ops, full), 10),
              "fused_epilogue_bwd": cuda_ms(
                  lambda i: cuda_epi.fused_epilogue_bwd_rows(x, w, ops, full,
                                                             dy), 10),
              "fused_epilogue_bwd_grads": cuda_ms(
                  lambda i: cuda_epi.fused_epilogue_bwd_grads(x, w, ops, g,
                                                              partial), 10)}
        plain_fwd = cuda_ms(lambda i: epilogue_forward_reference(
            x, w, ops, full), 5)
        plain_bwd = cuda_ms(lambda i: epilogue_backward_reference(
            x, w, ops, full, dy), 5)
        # yardsticks, f32 with TF32 off: for the forward of fc1 the one
        # call that fuses its bias and GELU; for the first backward launch
        # the product it replays (x . w), for the second the two products
        # it computes (dx = g . w^T, dw = x^T . g)
        lib = {"fused_epilogue_fwd": None,
               "fused_epilogue_bwd": cuda_ms(lambda i: torch.matmul(x, w),
                                             10),
               "fused_epilogue_bwd_grads": cuda_ms(
                   lambda i: (torch.matmul(g, w.t()),
                              torch.matmul(x.t(), g)), 10)}
        if label == "fc1":
            lib["fused_epilogue_fwd"] = cuda_ms(
                lambda i: torch._addmm_activation(ops[0][0], x, w,
                                                  use_gelu=True), 10)
        bounds = _epi_bounds(M, K, N, stages, 4, "float32")
        for name in EPI_KERNELS:
            b_ms, b_by, nbytes, nops = bounds[name]
            fwd = name == "fused_epilogue_fwd"
            chain = {"ms": ms[name], "plain_ms": plain_fwd if fwd
                     else plain_bwd, "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": nbytes, "operations": nops,
                     "library_ms": lib[name],
                     "library_call": EPI_LIBRARY_CALLS[name]}
            rows[name]["chains"][label] = chain
            for key in ("ms", "bound_ms", "bytes", "operations"):
                rows[name][key] += chain[key]
            if not fwd:
                rows[name]["library_ms"] = (rows[name].get("library_ms", 0.0)
                                            + chain["library_ms"])
            rows[name]["plain_ms"] += chain["plain_ms"]
            log("KERNEL " + json.dumps(dict(
                kernel=name, case=f"{label} M={M} K={K} N={N} float32",
                **chain)))
        del x, w, dy, ops, g, partial
        torch.cuda.empty_cache()
    for name, row in rows.items():
        row.setdefault("library_ms", None)
        row["library_call"] = EPI_LIBRARY_CALLS[name]
        row["bound_by"] = ("bytes" if all(c["bound_by"] == "bytes"
                                          for c in row["chains"].values())
                           else "operations")
        row["max_abs_err"] = worst["float32"]
        row["max_abs_err_bf16"] = worst["bfloat16"]
        row["case"] = (f"one BERT-base layer: proj, fc1 and fc2 chains at "
                       f"M={M}, float32, times summed")
        if name != "fused_epilogue_fwd":
            row["plain_computes"] = "the whole backward of the chain"
        log("KERNEL_LAYER " + json.dumps(dict(kernel=name, **row)))
    rows["fused_adam"] = _adam_phase(torch, gen)
    return rows


# --------------------------------------------------------------- phase 11
def phase_static_small_parity():
    """bench_pallas's CPU widths, 3 runs on the CPU and on the card from
    the same weights and constants: losses within rtol 1e-5, parameters
    within BERT_PARAM_ATOL (the key projections' biases within lr a
    step), the same realized kernels, and the kernels' launches on the
    card."""
    import numpy as np
    import torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework_io import program_state_from_paddle_tpu
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_bert_static
    cfg, runs = STATIC_CPU, 3
    built = {dev: build_bert_static(**cfg, device=dev)
             for dev in ("cpu", "cuda")}
    cpu_main = built["cpu"][0]
    program_state_from_paddle_tpu(
        built["cuda"][0], [p.detach().numpy() for p in cpu_main.parameters()],
        [v.numpy() for node in cpu_main.nodes for tag, v in node.in_specs
         if tag == "c"])
    losses, kernels = {}, {}
    for dev, (main, loss, feeds) in built.items():
        exe = static.Executor(dev)
        feed = {k: torch.from_numpy(v).to(dev)
                for k, v in feeds(np.random.RandomState(0)).items()}
        support.reset_launch_counts()
        losses[dev] = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                       for _ in range(runs)]
        kernels[dev] = next(iter(exe._cache.values())).kernels
    counts = dict(support.launch_counts)
    want = {k: v // STATIC_CHIP["layers"] * cfg["layers"] * runs
            for k, v in STATIC_PER_STEP.items() if k != "fused_adam"}
    want["fused_adam"] = runs
    if any(counts.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"small static BERT launches {counts}, want "
                             f"{want}")
    if (kernels["cpu"] != kernels["cuda"]
            or len(kernels["cuda"]) != 3 * cfg["layers"] + 1):
        raise AssertionError(f"realized kernels differ: {kernels}")
    diffs = [(p.detach().cpu() - q.detach()).abs().max().item()
             for p, q in zip(built["cuda"][0].parameters(),
                             cpu_main.parameters())]
    # parameters: tok, then 16 a layer (wq.w, wq.b, wk.w, wk.b, ...)
    k_bias = {1 + 16 * layer + 3 for layer in range(cfg["layers"])}
    rest = max(d for i, d in enumerate(diffs) if i not in k_bias)
    kb = max(diffs[i] for i in k_bias)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    out = {"losses_cpu": losses["cpu"], "losses_cuda": losses["cuda"],
           "loss_max_rel_err": loss_err, "param_max_abs_err": rest,
           "k_proj_bias_max_abs_err": kb, "loss_rtol": 1e-5,
           "param_atol": BERT_PARAM_ATOL, "k_proj_bias_atol": 2e-4 * runs,
           "kernels": kernels["cuda"], "launches": counts}
    log("STATIC_PARITY " + json.dumps(out))
    if (not loss_err <= 1e-5 or not rest <= BERT_PARAM_ATOL
            or not kb <= 2e-4 * runs):
        raise AssertionError(f"small static BERT card vs CPU: {out}")


# --------------------------------------------------------------- phase 12
def phase_static_training(warmup=2, steps=8):
    """bench_pallas's static BERT at its chip config on the card: losses
    finite and near ln(vocab), every kernel launched as often a step as
    the program has chains, flash calls and optimizers."""
    import numpy as np
    import torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import (build_bert_static,
                                                 palm_flops_per_step)
    cfg = STATIC_CHIP
    t0 = time.perf_counter()
    main, loss, feeds = build_bert_static(**cfg, device="cuda")
    exe = static.Executor("cuda")
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in feeds(np.random.RandomState(0)).items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    support.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0]))
    counts = dict(support.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in main.parameters())
    timed = step_ms[warmup:]
    mean_ms = sum(timed) / len(timed)
    tokens = cfg["batch"] * cfg["seq"]
    # the PaLM count; the token embedding is a lookup and the position
    # embedding a constant of the program
    flops = palm_flops_per_step(n_params - cfg["vocab"] * cfg["hidden"],
                                cfg["layers"], cfg["seq"], cfg["batch"],
                                cfg["hidden"])
    kernels = next(iter(exe._cache.values())).kernels
    out = {"config": cfg, "dtype": "float32", "optimizer": "Adam(1e-4)",
           "params_trained": n_params, "setup_s": setup_s,
           "warmup_runs": warmup, "timed_runs": steps, "losses": losses,
           "step_ms": timed, "step_ms_p50": float(np.median(timed)),
           "step_ms_mean": mean_ms, "first_runs_ms": step_ms[:warmup],
           "tokens_per_s": tokens / (mean_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu_f32": flops / (mean_ms / 1e3) / PEAK_OPS["float32"],
           "mfu_peak": "67 TFLOP/s, f32 on the CUDA cores",
           "peak_bound_ms": flops / PEAK_OPS["float32"] * 1e3,
           "max_memory_allocated": peak, "launches": counts,
           "realized_kernels": kernels, "compile_count": exe.compile_count}
    log("STATIC_TRAIN " + json.dumps(out))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg["vocab"])) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg['vocab']}) = "
                             f"{math.log(cfg['vocab'])}")
    runs = warmup + steps
    want = {k: v * runs for k, v in STATIC_PER_STEP.items()}
    if any(counts.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"static launches {counts}, want {want}")
    if exe.compile_count != 1:
        raise AssertionError(f"{exe.compile_count} builds, want 1")
    return counts, (exe, main, loss, feed)


# --------------------------------------------------------------- phase 13
# the f32 static step's kernels by name, and their launches a step: the
# register-tiled backward kernels of K2b and K1b
STATIC_NAMED = {"epilogue_fwd_f32_kernel": 36,
                "epilogue_bwd_f32_kernel": 36,
                "epilogue_grads_f32_kernel": 36, "flash_fwd_kernel": 12,
                "flash_bwd_dq_f32_kernel": 12, "flash_bwd_dkv_f32_kernel": 12}


def phase_static_anatomy(run, steps=2):
    exe, main, loss, feed = run
    launches = _step_anatomy("STATIC_ANATOMY", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], return_numpy=False), steps,
        lambda n: ("fused_epilogue" if "epilogue_" in n else
                   "fused_adam" if "adam_kernel" in n else
                   "flash" if "flash_" in n else
                   "cublas" if _is_gemm(n) else "other"))
    seen = {k: launches.get(k, 0) for k in STATIC_NAMED}
    if seen != STATIC_NAMED:
        raise AssertionError(f"static step kernels {seen}, want "
                             f"{STATIC_NAMED}")


# --------------------------------------------------------------- phase 14
def _cmm_bound(M, K, N, es, dtype_name):
    """Least time of one chunk product: x, w read once, out written
    once; 2 M K N operations at the dtype's peak."""
    nbytes = (M * K + K * N + M * N) * es
    ops = 2 * M * K * N
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_b, t_o), "bytes" if t_b >= t_o else "operations", nbytes,
            ops)


def _gpt_layer_chunks(cfg):
    """The six chunk products of one hybrid GPT layer at world size 1:
    (label, K, N)."""
    h, f = cfg["hidden"], cfg["ffn"]
    return [("q", h, h), ("k", h, h), ("v", h, h), ("proj", h, h),
            ("fc1", h, f), ("fc2", f, h)]


def phase_chunk_matmul():
    """K6 against its plain version: the chunk shapes of the full-width
    step (M 8192; K, N from 1792 and 7168 and their halves, the shards of
    mp 2), three ragged shapes at the gate's edges and strided views,
    f32 and bf16; the column blocks bitwise against K6 on the whole
    weight; times of one
    layer's six products at bf16 (the main path's dtype) beside the
    bound, the plain version and torch.matmul."""
    import torch
    from paddle_tpu_torch.ops.chunk_matmul import chunk_matmul_reference
    from paddle_tpu_torch.ops.cuda import chunk_matmul as k6
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    cfg = GPT_TRAIN
    M, h, f = cfg["batch"] * cfg["seq"], cfg["hidden"], cfg["ffn"]
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    shapes = [(M, K, N) for K, N in ((h, h), (h, f), (f, h), (h, h // 2),
                                     (h, f // 2), (h // 2, h), (f // 2, h))]
    # the gate's edges: the smallest M; an M off the 128-row tile; a K
    # off the 64-deep tile
    shapes += [(8, 128, 128), (1000, 384, 640), (1000, 96, 640)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for m, k, n in shapes:
        x, w = r(m, k), r(k, n) / math.sqrt(k)
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).replace("torch.", "")
            xd, wd = x.to(dt), w.to(dt)
            err = _rel_err(k6.chunk_matmul(xd, wd),
                           chunk_matmul_reference(xd, wd))
            worst[dname] = max(worst[dname], err)
            row = {"case": f"M={m} K={k} N={n} {dname}", "error": err,
                   "tol": CMM_TOL[dname]}
            log("CHUNK_MATMUL_CHECK " + json.dumps(row))
            if not err <= CMM_TOL[dname]:
                raise AssertionError(f"chunk_matmul disagrees with the "
                                     f"plain version: {row}")
        del x, w, xd, wd
    # x a row-strided view (ldx > K) and out a column block (ldo > N)
    xw, w = r(1000, 384), r(96, 640) / math.sqrt(96)
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        xs, wd = xw.to(dt)[:, 64:160], w.to(dt)
        out = torch.full((1000, 1280), float("nan"), device="cuda", dtype=dt)
        k6.chunk_matmul(xs, wd, out[:, 640:])
        torch.cuda.synchronize()
        err = _rel_err(out[:, 640:], chunk_matmul_reference(xs, wd))
        worst[dname] = max(worst[dname], err)
        row = {"case": f"M=1000 K=96 N=640 ldx=384 ldo=1280 {dname}",
               "error": err, "tol": CMM_TOL[dname]}
        log("CHUNK_MATMUL_CHECK " + json.dumps(row))
        if not err <= CMM_TOL[dname] or not bool(
                out[:, :640].float().isnan().all()):
            raise AssertionError(f"chunk_matmul on strided views: {row}")
    del xw, w, xs, wd, out
    # the column blocks of the ring form: each chunk written in place
    # into its block equals K6 on the whole weight, bit for bit
    x, w = r(M, h), r(h, f) / math.sqrt(h)
    for dt in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dt), w.to(dt)
        whole = k6.chunk_matmul(xd, wd)
        out = torch.full_like(whole, float("nan"))
        for j in range(f // h):
            k6.chunk_matmul(xd, wd[:, j * h:(j + 1) * h].contiguous(),
                            out[:, j * h:(j + 1) * h])
        torch.cuda.synchronize()
        if not torch.equal(out, whole):
            raise AssertionError(f"chunk_matmul column blocks differ from "
                                 f"the whole product ({dt})")
    log("CHUNK_MATMUL_BITWISE " + json.dumps({
        "case": f"M={M} K={h} N={f}: {f // h} chunks of {h} columns",
        "dtypes": ["float32", "bfloat16"], "equal": True}))
    del x, w, xd, wd, whole, out
    # times at the main path's shapes: one layer's six products, bf16
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "bytes": 0, "operations": 0}
    chunks = {}
    for label, K, N in _gpt_layer_chunks(cfg):
        x = r(M, K).to(torch.bfloat16)
        w = (r(K, N) / math.sqrt(K)).to(torch.bfloat16)
        out = torch.empty(M, N, device="cuda", dtype=torch.bfloat16)
        ms = cuda_ms(lambda i: k6.chunk_matmul(x, w, out), 20)
        plain = cuda_ms(lambda i: chunk_matmul_reference(x, w), 5)
        lib = cuda_ms(lambda i: torch.matmul(x, w, out=out), 20)
        b_ms, b_by, nbytes, ops = _cmm_bound(M, K, N, 2, "bfloat16")
        c = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib, "bytes": nbytes, "operations": ops,
             "tflops": ops / (ms * 1e-3) / 1e12}
        chunks[label] = c
        for key in total:
            total[key] += c[key]
        log("KERNEL " + json.dumps(dict(kernel="chunk_matmul",
                                        case=f"{label} M={M} K={K} N={N} "
                                             f"bfloat16", **c)))
        del x, w, out
    # f32 at one shape, for the record (no f32 chunk on the main path)
    x, w = r(M, h), r(h, h) / math.sqrt(h)
    f32 = {"ms": cuda_ms(lambda i: k6.chunk_matmul(x, w), 10),
           "library_ms": cuda_ms(lambda i: torch.matmul(x, w), 10),
           "bound_ms": _cmm_bound(M, h, h, 4, "float32")[0]}
    log("KERNEL " + json.dumps(dict(kernel="chunk_matmul",
                                    case=f"M={M} K={h} N={h} float32",
                                    **f32)))
    del x, w
    torch.cuda.empty_cache()
    row = dict(total, bound_by="operations" if all(
        c["bound_by"] == "operations" for c in chunks.values()) else "bytes",
        case=f"one GPT-1b layer's six chunk products (q, k, v, proj, fc1, "
             f"fc2) at M={M}, bfloat16, times summed",
        max_abs_err=worst["float32"], max_abs_err_bf16=worst["bfloat16"],
        library_call="torch.matmul (cuBLAS), bf16", chunks=chunks,
        float32_1792=f32)
    log("KERNEL_LAYER " + json.dumps(dict(kernel="chunk_matmul", **row)))
    return row


# --------------------------------------------------------------- phase 15
def phase_flash_block():
    """flash_attention_block against the plain version, forward and
    backward with a nonzero dlse, at the ring's four offset cases (f32
    and bf16, D 128, the 1b step's shard at sp 2: L 512, H 14; and at L
    192 for every other head dim the kernels are built for) and at
    the main path's call (B 8, L 1024, H 14, D 128, causal at offsets 0,
    the one call phase 17 makes at world size 1); the per-round merge
    composed over S = 2 and 4 virtual shards in one process against
    flash_attention over the whole sequence; times of the main path's
    call at bf16 beside the bound, the plain version and SDPA."""
    import torch
    from paddle_tpu_torch.ops.cuda.flash_attention import SUPPORTED_HEAD_DIMS
    from paddle_tpu_torch.ops.flash_attention import (
        NEG_INF, flash_attention, flash_attention_block,
        flash_attention_reference_bwd, flash_attention_reference_fwd)
    from paddle_tpu_torch.parallel.ring_attention import merge_blocks
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    cfg = GPT_TRAIN
    H = cfg["heads"]
    D = cfg["hidden"] // H
    Ls, B = cfg["seq"] // 2, 2
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    t = lambda x: x.transpose(1, 2)                              # noqa: E731
    L, Bt = cfg["seq"], cfg["batch"]
    # name: (batch, block length, q_off, k_off, causal)
    cases = {"diagonal": (B, Ls, Ls, Ls, True),
             "visible": (B, Ls, Ls, 0, True),
             "masked": (B, Ls, 0, Ls, True),
             "noncausal": (B, Ls, Ls, 0, False),
             "main_path": (Bt, L, 0, 0, True)}
    # the ring's cases at every other head dim, smaller
    for d in SUPPORTED_HEAD_DIMS:
        if d != D:
            cases.update({f"{name} D={d}": (B, 192, 192 * o_q // Ls,
                                             192 * o_k // Ls, c, d)
                          for name, (_, _, o_q, o_k, c) in list(
                              cases.items())[:4]})
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        for name, case in cases.items():
            Bc, Lc, q_off, k_off, causal = case[:5]
            Dc = case[5] if len(case) > 5 else D
            q, k, v, do = (r(Bc, Lc, H, Dc).to(dt) for _ in range(4))
            dlse = r(Bc, H, Lc)
            a = [x.clone().requires_grad_() for x in (q, k, v)]
            out, lse = flash_attention_block(*a, q_off, k_off, None, causal)
            grads = torch.autograd.grad((out, lse), a, (do, dlse))
            kw = dict(causal=causal, q_off=q_off, k_off=k_off)
            ro, rlse = flash_attention_reference_fwd(t(q), t(k), t(v), **kw)
            refs = flash_attention_reference_bwd(t(q), t(k), t(v), ro, rlse,
                                                 t(do), dlse, **kw)
            torch.cuda.synchronize()
            errs = {n: _rel_err(g, ref) for n, g, ref in [
                ("out", t(out), ro), ("lse", lse, rlse),
                ("dq", t(grads[0]), refs[0]), ("dk", t(grads[1]), refs[1]),
                ("dv", t(grads[2]), refs[2])]}
            err = max(errs.values())
            worst[dname] = max(worst[dname], err)
            row = {"case": f"{name} B={Bc} L={Lc} H={H} D={Dc} {dname} "
                           f"q_off={q_off} k_off={k_off} causal={causal}",
                   "errors": errs, "tol": FLASH_TOL[dname]}
            if name.startswith("masked"):
                row["masked_rows_zero"] = bool(
                    (lse == NEG_INF).all() and (out == 0).all()
                    and all((g == 0).all() for g in grads))
                if not row["masked_rows_zero"]:
                    raise AssertionError(f"fully masked block: {row}")
            log("FLASH_BLOCK_CHECK " + json.dumps(row))
            if not err <= FLASH_TOL[dname]:
                raise AssertionError(f"flash block entry disagrees with the "
                                     f"plain version: {row}")
            del q, k, v, do, dlse, a, out, lse, grads, ro, rlse, refs
        torch.cuda.empty_cache()
    # the ring's rounds and merges, S virtual shards in one process
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        q, k, v, w = (r(B, L, H, D).to(dt) for _ in range(4))
        b = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = flash_attention(*b, causal=True)
        rgrads = torch.autograd.grad((ref.float() * w.float()).sum(), b)
        for S in (2, 4):
            n = L // S
            a = [x.clone().requires_grad_() for x in (q, k, v)]
            outs = []
            for my in range(S):
                o = lse = None
                for rnd in range(S):
                    src = (my - rnd) % S
                    o_b, lse_b = flash_attention_block(
                        a[0][:, my * n:(my + 1) * n],
                        a[1][:, src * n:(src + 1) * n],
                        a[2][:, src * n:(src + 1) * n], my * n, src * n,
                        None, True)
                    if o is None:
                        o, lse = o_b.float(), lse_b
                    else:
                        o, lse = merge_blocks(o, lse, o_b, lse_b)
                outs.append(o.to(dt))
            out = torch.cat(outs, dim=1)
            grads = torch.autograd.grad((out.float() * w.float()).sum(), a)
            torch.cuda.synchronize()
            errs = {n_: _rel_err(g, rr) for n_, g, rr in [
                ("out", out, ref), ("dq", grads[0], rgrads[0]),
                ("dk", grads[1], rgrads[1]), ("dv", grads[2], rgrads[2])]}
            row = {"case": f"S={S} virtual shards of L={L}, B={B} H={H} "
                           f"D={D} {dname} causal", "errors": errs,
                   "tol": FLASH_TOL[dname]}
            log("RING_COMPOSE_CHECK " + json.dumps(row))
            if not max(errs.values()) <= FLASH_TOL[dname]:
                raise AssertionError(f"composed ring rounds disagree with "
                                     f"flash_attention: {row}")
        del q, k, v, w, b, ref, rgrads, a, out, grads
    torch.cuda.empty_cache()
    # times at the main path's call
    rows = _flash_time_rows(torch, gen, Bt, L, H, D, torch.bfloat16, True,
                            0.0, 0, entry="flash_attention_block")
    for row in rows.values():
        row["max_abs_err"] = worst["float32"]
        row["max_abs_err_bf16"] = worst["bfloat16"]
    return rows


# --------------------------------------------------------------- phase 16
def phase_small_gpt_parity(steps=3):
    """One rank over a process group that carries both backends (gloo
    for CPU tensors, NCCL for CUDA tensors); the small hybrid GPT (the
    tests' widths, f32, dropout 0) trained 3 SpmdTrainSteps on the card
    and on the CPU from the same weights: losses rtol 1e-5, parameters
    within BERT_PARAM_ATOL (the key projections' biases within lr a
    step, as phase 7), and K6 and the flash block entry launched as
    often as the model has chunk products and attention calls."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_gpt_hybrid
    from paddle_tpu_torch.testing.parallel_cases import gpt_run
    init_parallel_env(backend="cpu:gloo,cuda:nccl")
    for dev in ("cpu", "cuda"):           # both backends answer
        one = torch.ones(1, device=dev)
        dist.all_reduce(one)
        if one.item() != 1.0:
            raise AssertionError(f"one-rank all_reduce on {dev}: {one}")
    cfg = GPT_SMALL
    rng.seed(7)
    state = {k: v.numpy() for k, v in build_gpt_hybrid(
        cfg["vocab"], cfg["hidden"], cfg["layers"], cfg["heads"],
        cfg["ffn"], cfg["seq"], 0.0, device="cpu").state_dict().items()}
    data = np.random.RandomState(0)
    batch = tuple(data.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]))
                  for _ in range(2))
    losses, models = {}, {}
    for dev in ("cpu", "cuda"):
        support.reset_launch_counts()
        losses[dev], models[dev] = gpt_run(cfg, state, batch, steps,
                                           {"dp": 1}, dev)
        counts = dict(support.launch_counts)
    # ring attention reaches the flash kernels only through the block
    # entry, so every flash launch here is one of its
    want = {"chunk_matmul": 6 * cfg["layers"] * steps}
    want.update({k: cfg["layers"] * steps for k in FLASH_KERNELS})
    if any(counts.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"small GPT launches {counts}, want {want}")
    gp = dict(models["cuda"].named_parameters())
    diffs = {n: (gp[n].detach().cpu() - p.detach()).abs().max().item()
             for n, p in models["cpu"].named_parameters()}
    k_bias = {n: d for n, d in diffs.items() if n.endswith(".k.bias")}
    rest = {n: d for n, d in diffs.items() if n not in k_bias}
    worst = max(rest, key=rest.get)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    out = {"config": cfg, "losses_cpu": losses["cpu"],
           "losses_cuda": losses["cuda"], "loss_max_rel_err": loss_err,
           "param_max_abs_err": rest[worst], "param_worst": worst,
           "k_bias_max_abs_err": max(k_bias.values()), "loss_rtol": 1e-5,
           "param_atol": BERT_PARAM_ATOL, "k_bias_atol": 2e-4 * steps,
           "launches": counts, "backend": dist.get_backend()}
    log("GPT_PARITY " + json.dumps(out))
    if (not loss_err <= 1e-5 or not rest[worst] <= BERT_PARAM_ATOL
            or not max(k_bias.values()) <= 2e-4 * steps):
        raise AssertionError(f"small hybrid GPT card vs CPU: {out}")


# --------------------------------------------------------------- phase 17
def phase_gpt_training(warmup=2, steps=8):
    """The hybrid GPT at the 1b widths, uncut (batch 8, seq 1024,
    dropout 0.1, O2 bf16 with f32 masters, AdamW, global-norm clip 1.0)
    through SpmdTrainStep at world size 1: losses finite, the first near
    ln(vocab), and per step 144 K6 launches (6 a layer) and 24 of each
    flash kernel, all through the block entry."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.distributed import init_mesh
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.parallel import SpmdTrainStep
    from paddle_tpu_torch.testing.models import (build_gpt_hybrid, gpt_loss,
                                                 gpt_flops_per_step)
    cfg = GPT_TRAIN
    t0 = time.perf_counter()
    mesh = init_mesh({"dp": 1})
    rng.seed(2024)
    model = build_gpt_hybrid(cfg["vocab"], cfg["hidden"], cfg["layers"],
                             cfg["heads"], cfg["ffn"], cfg["seq"],
                             cfg["dropout"], device="cuda")
    opt = optimizer.AdamW(learning_rate=2e-4, parameters=model.parameters(),
                          weight_decay=0.01,
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                          multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = SpmdTrainStep(model, gpt_loss(model), opt, mesh=mesh)
    data = np.random.RandomState(0)
    x, y = (torch.from_numpy(data.randint(0, cfg["vocab"],
                                          (cfg["batch"], cfg["seq"])))
            .cuda() for _ in range(2))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    support.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = dict(support.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[warmup:]
    mean_ms = sum(timed) / len(timed)
    tokens = cfg["batch"] * cfg["seq"]
    flops = gpt_flops_per_step(cfg["vocab"], cfg["hidden"], cfg["layers"],
                               cfg["seq"], cfg["batch"], cfg["ffn"])
    out = {"config": cfg, "mesh": mesh.shape,
           "dtype": "bfloat16 O2, f32 master weights",
           "params": sum(p.numel() for p in model.parameters()),
           "setup_s": setup_s, "warmup_steps": warmup, "timed_steps": steps,
           "losses": losses, "step_ms": timed,
           "step_ms_p50": float(np.median(timed)), "step_ms_mean": mean_ms,
           "first_steps_ms": step_ms[:warmup],
           "tokens_per_s": tokens / (mean_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu": flops / (mean_ms / 1e3) / PEAK_OPS["bfloat16"],
           "peak_bound_ms": flops / PEAK_OPS["bfloat16"] * 1e3,
           "max_memory_allocated": peak, "launches": counts}
    log("GPT_TRAIN " + json.dumps(out))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg["vocab"])) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg['vocab']}) = "
                             f"{math.log(cfg['vocab'])}")
    runs = warmup + steps
    want = {k: n * runs for k, n in GPT_PER_STEP.items()}
    if any(counts.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"hybrid GPT launches {counts}, want {want}")
    return counts, step, (x, y)


def phase_gpt_anatomy(step, batch, steps=2):
    x, y = batch
    _step_anatomy("GPT_ANATOMY", lambda: step(x, y), steps, lambda n: (
        "chunk_matmul" if "chunk_mm" in n else
        "flash_fwd" if "flash_fwd_" in n else
        "flash_bwd" if "flash_bwd_" in n else
        "nccl" if "nccl" in n else
        "cublas" if _is_gemm(n) else "other"), wgmma_flash=True)


# --------------------------------------------------------------- phase 18
def phase_multicard(steps=3):
    """Where the machine shows two cards or more: min(4, count) NCCL
    ranks (spawned, one card each) on {"mp": 2, "sp": n / 2} (or {"sp":
    2} on two cards) train the hybrid GPT at the 1b widths with 2 layers
    (f32, dropout 0, batch 4) for 3 steps from seeded weights; their
    losses against a world-size-1 run of the same model and weights on
    this process's card, rtol 1e-4 (f32 sums over shards in other
    orders, then 3 AdamW steps).  On one card it says it did not run."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed.launch import free_port, spawn
    from paddle_tpu_torch.testing import parallel_cases
    count = torch.cuda.device_count()
    if count < 2:
        log("MULTICARD " + json.dumps({
            "ran": False, "device_count": count,
            "why": "needs two CUDA devices or more: NCCL refuses two ranks "
                   "on one card (Duplicate GPU detected)"}))
        return None
    n = 4 if count >= 4 else 2
    shape = {"mp": 2, "sp": n // 2} if n == 4 else {"sp": 2}
    cfg = dict(GPT_TRAIN, layers=2, dropout=0.0, batch=4)
    outdir = os.path.join(ROOT, "build", "chip_smoke_multicard")
    os.makedirs(outdir, exist_ok=True)
    data = np.random.RandomState(18)
    gx, gy = (data.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]))
              for _ in range(2))
    inputs = {f"cfg.{k}": np.asarray(cfg[k]) for k in
              ("vocab", "hidden", "layers", "heads", "ffn", "seq")}
    inputs.update(mesh_axes=np.asarray(",".join(shape)),
                  mesh_sizes=np.asarray(list(shape.values())), gx=gx, gy=gy,
                  steps=np.asarray(steps))
    np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
    t0 = time.perf_counter()
    spawn(parallel_cases.run, (outdir, ["gpt_multicard"], "cuda"),
          nprocs=n, init_method=f"tcp://localhost:{free_port()}",
          timeout=600)
    spawn_s = time.perf_counter() - t0
    ref, _ = parallel_cases.gpt_run(cfg, None, (gx, gy), steps, {"dp": 1},
                                    "cuda")
    ranks = [np.load(os.path.join(outdir, f"rank{r}.npz"))[
        "gpt_multicard/losses"].tolist() for r in range(n)]
    err = max(abs(a - b) / abs(b) for lr in ranks for a, b in zip(lr, ref))
    out = {"ran": True, "ranks": n, "mesh": shape, "config": cfg,
           "losses_world_1": ref, "losses_by_rank": ranks,
           "loss_max_rel_err": err, "rtol": 1e-4, "spawn_s": spawn_s}
    log("MULTICARD " + json.dumps(out))
    if not err <= 1e-4:
        raise AssertionError(f"multi-card losses disagree: {out}")
    torch.cuda.empty_cache()
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    seconds = {}
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    timed("environment", phase_environment)
    kernel_rows = timed("paged_kernel", phase_kernels)
    timed("small_model", phase_small_model_parity)
    launches, model, kv = timed("serving", phase_serving)
    timed("decode_anatomy", phase_anatomy, model, kv)
    del model, kv
    torch.cuda.empty_cache()
    flash_rows = timed("flash_kernels", phase_flash_kernels)
    timed("small_bert", phase_small_bert_parity)
    flash_launches, bert, step, batch = timed("bert_training",
                                              phase_bert_training)
    timed("train_anatomy", phase_train_anatomy, step, batch)
    del bert, step, batch
    torch.cuda.empty_cache()
    epi_rows = timed("epilogue_adam_kernels", phase_epilogue_adam_kernels)
    timed("static_small", phase_static_small_parity)
    static_launches, run = timed("static_training", phase_static_training)
    timed("static_anatomy", phase_static_anatomy, run)
    del run
    torch.cuda.empty_cache()
    cmm_row = timed("chunk_matmul_kernel", phase_chunk_matmul)
    block_rows = timed("flash_block", phase_flash_block)
    timed("small_gpt", phase_small_gpt_parity)
    gpt_launches, gstep, gbatch = timed("gpt_training", phase_gpt_training)
    timed("gpt_anatomy", phase_gpt_anatomy, gstep, gbatch)
    del gstep, gbatch
    torch.cuda.empty_cache()
    timed("multicard", phase_multicard)
    seconds["total"] = time.perf_counter() - t0
    log("PHASE_SECONDS " + json.dumps(seconds))
    f32_err = max(r["max_abs_err"] for r in kernel_rows
                  if r["case"].endswith("float32"))
    head = next(r for r in kernel_rows
                if r["case"].endswith("P=64 L=24 float32"))
    kernels = [{
        "name": "paged_attention_decode", "route": "cuda",
        "source": "paddle_tpu_torch/ops/cuda/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:63",
        "launches": launches,
        "max_abs_err": f32_err, "max_err": f32_err,
        "max_abs_err_bf16": max(r["max_abs_err"] for r in kernel_rows
                                if r["case"].endswith("bfloat16")),
        "shape": head["case"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None}]
    for name, site in FLASH_KERNELS.items():
        r, b = flash_rows[name], block_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu",
            "replaces": site,
            "launches": flash_launches[name] + gpt_launches[name],
            "launches_by_entry": {"flash_attention": flash_launches[name],
                                  "flash_attention_block":
                                      gpt_launches[name]},
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_bf16": r["max_abs_err_bf16"], "shape": r["case"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "block_entry": {k: b[k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "max_abs_err_bf16")},
            **{extra: {k: r[extra][k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_call")}
               for extra in ("gpt_760m", "static_f32")}})
    for name, site in list(EPI_KERNELS.items()) + [("fused_adam",
                                                    ADAM_SITE)]:
        r = epi_rows[name]
        src = ("fused_adam.cu" if name == "fused_adam"
               else "fused_epilogue.cu")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/cuda/csrc/{src}",
            "replaces": site, "launches": static_launches.get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_bf16": r.get("max_abs_err_bf16"),
            "shape": r.get("case", f"{r.get('tensors')} tensors, "
                                   f"{r.get('numel')} elements, float32"),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": r.get("library_call")})
    kernels.append({
        "name": "chunk_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/ops/cuda/csrc/chunk_matmul.cu",
        "replaces": CMM_SITE, "launches": gpt_launches["chunk_matmul"],
        "max_abs_err": cmm_row["max_abs_err"],
        "max_abs_err_bf16": cmm_row["max_abs_err_bf16"],
        "shape": cmm_row["case"], "ms": cmm_row["ms"],
        "plain_ms": cmm_row["plain_ms"], "bound_ms": cmm_row["bound_ms"],
        "bound_by": cmm_row["bound_by"],
        "library_ms": cmm_row["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        code = main()
    except Exception:                  # noqa: BLE001 - report, exit 1
        import traceback
        traceback.print_exc()
        code = 1
    sys.exit(code)
