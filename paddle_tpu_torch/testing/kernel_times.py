"""Timers and the paged-decode cases ``chip_smoke.py`` times its kernels
with, and the same timings of any checkout of this repository:

    python3 paddle_tpu_torch/testing/kernel_times.py [--root DIR]

times the paged decode and the f32 flash forward of the checkout at
``DIR`` (this one by default; e.g. the parent commit unpacked with ``git
archive``) through that checkout's own wrappers, with this file's cases
and timers: phase 2's paged-decode cases (the same seeded draws) and the
static BERT's attention shape (B 16, L 512, H 12, D 64, f32, not causal,
no dropout).  Each kernel is first held to that checkout's plain
version.  It prints one ``TIMES`` JSON line a case, with the CUDA-event
time a call over back-to-back calls (``event_ms``, chip_smoke's ``ms``)
and the profiler's device time a launch (``device_ms``: the kernel's
own, where a short kernel leaves the card idle between calls), then the
card's name and power limit as ``nvidia-smi`` gives them.  To compare
two checkouts on one card, run them in one call in the order other,
this, this, other.  Needs a CUDA card and nvcc.

This module imports torch only, so it can time another checkout's
package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys

import torch

# phase 2's geometry: the GPT 1b serving model's 24 layers, 8 slots,
# pages of 16 tokens, a pool for 8 sequences of 1024 tokens
PAGE, SLOTS, LAYERS, HEAD_DIM = 16, 8, 24, 128
NUM_PAGES = SLOTS * (1024 // PAGE) + 1
ITERS = 48


def cuda_ms(fn, iters, warmup=3):
    """Mean CUDA-event time (ms) of one call of ``fn(i)`` over ``iters``
    back-to-back calls."""
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


def device_ms(fn, iters, match, attempts=3):
    """Mean device time (ms) of one launch of the kernels whose profiler
    name holds ``match``, over ``iters`` calls of ``fn(i)``: the kernel's
    own time, where back-to-back launches through a Python wrapper would
    leave the card idle between short kernels.  A trace that caught fewer
    launches than were made (the tracer at times misses a whole session,
    or one launch of it) is taken again, up to ``attempts`` times; more
    launches than were made, or too few in every attempt, raise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and match in e.key:
                total += e.self_device_time_total
                count += e.count
        # the trace's event trees are cyclic garbage: reclaim them here,
        # not in a Python GC pause inside a later timing
        del prof
        gc.collect()
        if count >= iters:
            break
    if count != iters:
        raise AssertionError(f"{count} launches of {match}, want {iters}")
    return total / count / 1e3


def paged_cases(gen):
    """Phase 2's cases ``(label, H, Hkv, P, dtype, lengths)``: table
    widths of 1, 8 and 64 pages with seeded lengths (one of 1 and one
    full in each), GQA, bf16, and the decode anatomy's 8 slots at 600."""
    cases = []
    for P in (1, 8, 64):
        full = P * PAGE
        lens = [1, full] + [int(x) for x in torch.randint(
            1, full + 1, (SLOTS - 2,), generator=gen, device=gen.device)]
        cases.append(("mha", 14, 14, P, torch.float32, lens))
    cases.append(("gqa", 16, 4, 8, torch.float32,
                  [1, 128, 77, 3, 64, 100, 17, 128]))
    cases.append(("mha", 14, 14, 64, torch.bfloat16,
                  [1, 1024, 700, 512, 33, 999, 256, 640]))
    cases.append(("anatomy", 14, 14, 64, torch.float32, [600] * SLOTS))
    return cases


def paged_inputs(gen, H, Hkv, P, dtype, lengths, layers=LAYERS,
                 num_pages=NUM_PAGES):
    """q [SLOTS, H, D], stacked pools [layers, num_pages, PAGE, Hkv, D],
    a table [SLOTS, P] of distinct pages (as the engine allocates them,
    page 0 never used) and the lengths, on the generator's device."""
    dev = gen.device
    q = torch.randn((SLOTS, H, HEAD_DIM), generator=gen, device=dev)
    k = torch.randn((layers, num_pages, PAGE, Hkv, HEAD_DIM), generator=gen,
                    device=dev)
    v = torch.randn((layers, num_pages, PAGE, Hkv, HEAD_DIM), generator=gen,
                    device=dev)
    perm = torch.randperm(num_pages - 1, generator=gen,
                          device=dev)[:SLOTS * P] + 1
    table = perm.reshape(SLOTS, P).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype), table, lens


def time_paged(decode, q, k, v, table, lengths, scale):
    """(event ms, device ms) of ``decode`` over ITERS calls that cycle
    through the layers, so consecutive launches read other memory, as
    the decode step's 24 calls do."""
    def call(i):
        return decode(q, k, v, table, lengths, scale=scale, layer=i % LAYERS)

    return cuda_ms(call, ITERS), device_ms(call, ITERS, "paged_decode")


def _time_checkout(root):
    """The TIMES rows of the checkout at ``root``."""
    sys.path.insert(0, root)
    from paddle_tpu_torch.core.dtype import dtype_name
    from paddle_tpu_torch.ops.attention import paged_attention_reference
    from paddle_tpu_torch.ops.cuda import (flash_attention_fwd,
                                           paged_attention_decode)
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_reference_fwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    scale = 1.0 / math.sqrt(HEAD_DIM)
    rows = []
    for label, H, Hkv, P, dtype, lens in paged_cases(gen):
        q, k, v, table, lengths = paged_inputs(gen, H, Hkv, P, dtype, lens)
        got = paged_attention_decode(q, k, v, table, lengths, scale=scale,
                                     layer=0)
        ref = paged_attention_reference(q, k, v, table, lengths,
                                        scale=scale, layer=0)
        err = (got.float() - ref.float()).abs().max().item()
        tol = 2e-5 if dtype == torch.float32 else 1e-2
        if not err <= tol:
            raise AssertionError(f"paged {label} P={P}: error {err}")
        event, dev = time_paged(paged_attention_decode, q, k, v, table,
                                lengths, scale)
        rows.append({"case": f"paged {label} H={H} Hkv={Hkv} P={P} "
                             f"{dtype_name(dtype)}",
                     "event_ms": event, "device_ms": dev,
                     "max_abs_err": err})
        del q, k, v, table, lengths, got, ref
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    q, k, v = (torch.randn((16, 512, 12, 64), generator=g, device="cuda")
               for _ in range(3))
    out, lse = flash_attention_fwd(q, k, v, scale=0.125)
    ro, rlse = flash_attention_reference_fwd(
        *(x[:2].transpose(1, 2) for x in (q, k, v)), scale=0.125)
    err = max(((out[:2].transpose(1, 2) - ro).abs().max()
               / ro.abs().max().clamp_min(1)).item(),
              ((lse[:2] - rlse).abs().max()
               / rlse.abs().max().clamp_min(1)).item())
    if not err <= 2e-5:
        raise AssertionError(f"flash forward: error {err}")

    def fwd(i):
        return flash_attention_fwd(q, k, v, scale=0.125)

    rows.append({"case": "flash forward B=16 L=512 H=12 D=64 float32",
                 "event_ms": cuda_ms(fwd, ITERS),
                 "device_ms": device_ms(fwd, ITERS, "flash_fwd"),
                 "max_err": err})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="root of the checkout to time (default: this one)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    for row in _time_checkout(root):
        print("TIMES " + json.dumps({"root": root, **row}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
