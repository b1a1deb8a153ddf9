"""paddle_tpu_torch stands alone: importing it pulls in neither JAX nor
the JAX package (nor Triton, nor a kernel build), and no module of it
imports either.  Without a GPU, what is placed by default raises unless
``set_device("cpu")`` asked for the CPU."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")


def test_import_leaves_jax_and_paddle_tpu_out():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.ops.cuda, paddle_tpu_torch.ops.flash_attention, "
            "paddle_tpu_torch.nn, paddle_tpu_torch.nn.functional, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.amp, "
            "paddle_tpu_torch.jit, paddle_tpu_torch.framework_io, "
            "paddle_tpu_torch.testing.models, paddle_tpu_torch.core.rng, "
            "paddle_tpu_torch.static, paddle_tpu_torch.static.executor, "
            "paddle_tpu_torch.static.analysis.fusion, "
            "paddle_tpu_torch.static.analysis.cost, "
            "paddle_tpu_torch.static.analysis.graph, "
            "paddle_tpu_torch.static.nn, paddle_tpu_torch.core.dispatch, "
            "paddle_tpu_torch.device, paddle_tpu_torch.ops.fused_epilogue, "
            "paddle_tpu_torch.ops.fused_adam, paddle_tpu_torch.ops.creation, "
            "paddle_tpu_torch.ops.cuda.fused_epilogue, "
            "paddle_tpu_torch.ops.cuda.fused_adam, "
            "paddle_tpu_torch.ops.chunk_matmul, "
            "paddle_tpu_torch.ops.cuda.chunk_matmul, "
            "paddle_tpu_torch.ops.collective_matmul, "
            "paddle_tpu_torch.distributed, paddle_tpu_torch.distributed.env, "
            "paddle_tpu_torch.distributed.mesh, "
            "paddle_tpu_torch.distributed.collective, "
            "paddle_tpu_torch.distributed.grad_comm, "
            "paddle_tpu_torch.distributed.launch, "
            "paddle_tpu_torch.distributed.strategy, "
            "paddle_tpu_torch.parallel, paddle_tpu_torch.parallel.tp_layers, "
            "paddle_tpu_torch.parallel.ring_attention, "
            "paddle_tpu_torch.parallel.data_parallel, "
            "paddle_tpu_torch.parallel.spmd_train_step, "
            "paddle_tpu_torch.testing.parallel_cases, "
            "paddle_tpu_torch.ops.pallas, paddle_tpu_torch.ops.attention, "
            "paddle_tpu_torch.optimizer.extras, "
            "paddle_tpu_torch.framework_compat, "
            "paddle_tpu_torch.core.profiler_hook, "
            "paddle_tpu_torch.core.flags, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.jit.save_load, paddle_tpu_torch.jit.dy2static, "
            "paddle_tpu_torch.jit.lint, paddle_tpu_torch.static.io, "
            "paddle_tpu_torch.serving.engine, "
            "paddle_tpu_torch.serving.registry, "
            "paddle_tpu_torch.serving.http, paddle_tpu_torch.serving.serve, "
            "paddle_tpu_torch.inference.capi, paddle_tpu_torch.testing.chaos, "
            "paddle_tpu_torch.testing.fault, paddle_tpu_torch.utils.monitor, "
            "paddle_tpu_torch.utils.checkpoint, "
            "paddle_tpu_torch.serving.hotswap, "
            "paddle_tpu_torch.observability, "
            "paddle_tpu_torch.observability.tracer, "
            "paddle_tpu_torch.observability.compiles, "
            "paddle_tpu_torch.observability.metrics, "
            "paddle_tpu_torch.observability.slo, "
            "paddle_tpu_torch.observability.perf, "
            "paddle_tpu_torch.observability.flight, "
            "paddle_tpu_torch.observability.export, "
            "paddle_tpu_torch.observability.fleet\n"
            "from paddle_tpu_torch.ops.cuda import support\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'paddle_tpu.', 'triton')) "
            "or m == 'paddle_tpu')\n"
            "print(bad)\n"
            "assert not bad, bad\n"
            "assert support._lib is None and not support.build_info\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_module_imports_jax_or_paddle_tpu():
    pat = re.compile(r"^\s*(import\s+(jax|paddle_tpu)\b|from\s+(jax|"
                     r"paddle_tpu)(\.|\s))", re.M)
    hits = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        hits.append(os.path.relpath(path, ROOT))
    assert not hits, hits
    # the scan itself would catch the imports it is for
    assert pat.search("import jax.numpy as jnp")
    assert pat.search("from paddle_tpu.serving import x")
    assert not pat.search("from paddle_tpu_torch.serving import x")


def test_c_abi_and_go_sources_name_neither_jax_nor_paddle_tpu():
    """The C shim and the Go binding drive ``paddle_tpu_torch`` only,
    and no binary is kept beside their sources (the shim is built at
    first use under ``build/``)."""
    hits, binaries = [], []
    for sub in ("csrc", "go"):
        top = os.path.join(PKG, "inference", sub)
        for dirpath, _, files in os.walk(top):
            for f in files:
                path = os.path.join(dirpath, f)
                if f.endswith((".so", ".o", ".a")):
                    binaries.append(path)
                    continue
                text = open(path).read().replace("paddle_tpu_torch", "")
                if re.search(r"\bjax\b|\bpaddle_tpu\b", text):
                    hits.append(os.path.relpath(path, ROOT))
    assert not hits, hits
    assert not binaries, binaries


def test_static_placement_without_a_gpu():
    """``static.Executor()`` and ``build_bert_static()`` with no device
    raise on a machine without a GPU; after ``set_device("cpu")`` both
    take the CPU."""
    code = ("import torch, pytest\n"
            "import paddle_tpu_torch as pt\n"
            "from paddle_tpu_torch import static\n"
            "from paddle_tpu_torch.testing.models import build_bert_static\n"
            "assert not torch.cuda.is_available()\n"
            "cfg = dict(vocab=64, hidden=128, layers=1, heads=2, ffn=256, "
            "seq=8, batch=2)\n"
            "for fn in (static.Executor, lambda: build_bert_static(**cfg)):\n"
            "    with pytest.raises(RuntimeError, match='CUDA'):\n"
            "        fn()\n"
            "assert pt.set_device('cpu') == torch.device('cpu')\n"
            "assert pt.get_device() == 'cpu'\n"
            "assert static.Executor().place == torch.device('cpu')\n"
            "main, loss, _ = build_bert_static(**cfg)\n"
            "assert all(p.device.type == 'cpu' for p in main.parameters())\n"
            "assert pt.arange(3).device.type == 'cpu'\n"
            "with pytest.raises(RuntimeError, match='CUDA'):\n"
            "    pt.set_device('gpu')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
