"""paddle_tpu_torch stands alone: importing it pulls in neither JAX nor
the JAX package, and no module of it imports either."""
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
            "paddle_tpu_torch.testing.models, paddle_tpu_torch.core.rng\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'paddle_tpu.')) "
            "or m == 'paddle_tpu')\n"
            "print(bad)\n"
            "assert not bad, bad\n")
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
