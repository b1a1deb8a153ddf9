"""The port's Go binding (``paddle_tpu_torch/inference/go``) over its C
ABI, held as ``tests/test_go_binding.py`` holds the JAX package's.

- without Go (this machine has none): the cgo sources call only ``PT_*``
  symbols the port's header declares, their cgo flags point at the
  port's header and build directory, and a C probe that names every
  function and ``PT_Output`` compiles and links against the built
  ``libpaddle_tpu_torch_capi.so``;
- with Go: ``go vet``, ``go build`` and the example on the CPU against a
  saved model (skipped without a toolchain).
"""
import os
import re
import shutil
import site
import subprocess

import numpy as np
import pytest

import paddle_tpu_torch
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.inference import capi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GO_DIR = os.path.join(ROOT, "paddle_tpu_torch", "inference", "go")
HEADER = os.path.join(capi.CSRC, "paddle_tpu_capi.h")
ABI = {"PT_NewPredictor", "PT_PredictorRun", "PT_GetOutput",
       "PT_FreeOutput", "PT_DeletePredictor"}


def _header_symbols():
    src = open(HEADER).read()
    fns = set(re.findall(r"\b(PT_[A-Za-z]+)\s*\(", src))
    types = set(re.findall(r"\b(?:struct|typedef struct)\s+"
                           r"(PT_[A-Za-z]+)", src))
    return fns | types


def _go_sources():
    out = []
    for root, _, files in os.walk(GO_DIR):
        out += [os.path.join(root, f) for f in files if f.endswith(".go")]
    return sorted(out)


def test_go_sources_reference_only_declared_symbols():
    declared = _header_symbols()
    assert ABI | {"PT_Output", "PT_Predictor"} <= declared
    used = set()
    for path in _go_sources():
        used |= set(re.findall(r"C\.(PT_[A-Za-z]+)", open(path).read()))
    assert used, "go sources must call the C ABI"
    assert used <= declared, used - declared
    assert ABI - {"PT_FreeOutput"} <= used


def test_cgo_flags_point_at_the_port():
    src = open(os.path.join(GO_DIR, "paddle", "predictor.go")).read()
    cflags = re.search(r"#cgo CFLAGS: -I\$\{SRCDIR\}/(\S+)", src).group(1)
    ldflags = re.search(r"#cgo LDFLAGS: -L\$\{SRCDIR\}/(\S+) -l(\S+)",
                        src)
    here = os.path.join(GO_DIR, "paddle")
    assert os.path.samefile(os.path.join(here, cflags), capi.CSRC)
    assert os.path.normpath(os.path.join(here, ldflags.group(1))) == \
        os.path.normpath(capi.BUILD_DIR)
    assert "lib" + ldflags.group(2) + ".so" == capi.LIB_NAME
    assert '#include "paddle_tpu_capi.h"' in src
    for path in _go_sources():
        text = open(path).read()
        assert "paddle_tpu/inference" not in text.replace(
            "paddle_tpu_torch/inference", ""), path


def test_header_compiles_and_links_against_the_built_library(tmp_path):
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    probe = tmp_path / "probe.c"
    probe.write_text(
        '#include "paddle_tpu_capi.h"\n'
        "int main(void) {\n"
        "  PT_Output o; o.ndim = 0; o.numel = 0; o.data = 0; o.shape = 0;\n"
        "  (void)o;\n"
        "  void* fns[] = {(void*)PT_NewPredictor, (void*)PT_PredictorRun,\n"
        "                 (void*)PT_GetOutput, (void*)PT_FreeOutput,\n"
        "                 (void*)PT_DeletePredictor};\n"
        "  (void)fns; return 0;\n"
        "}\n")
    so = capi._build()
    out = tmp_path / "probe"
    r = subprocess.run(
        ["gcc", "-Wall", "-Werror", str(probe), f"-I{capi.CSRC}",
         f"-L{os.path.dirname(so)}", "-lpaddle_tpu_torch_capi",
         f"-Wl,-rpath,{os.path.dirname(so)}", *capi.python_link_flags(),
         "-o", str(out)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    nm = subprocess.run(["nm", "-D", "--defined-only", so],
                        capture_output=True, text=True)
    if nm.returncode == 0:
        exported = set(re.findall(r"\bT (PT_[A-Za-z]+)", nm.stdout))
        assert exported == ABI, exported


@pytest.mark.skipif(shutil.which("go") is None,
                    reason="no Go toolchain on this machine")
def test_go_build_and_run_example(tmp_path):
    from paddle_tpu_torch import jit, nn
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    try:
        paddle_tpu_torch.seed(0)
        net = nn.Sequential(nn.Flatten(), nn.Linear(16, 10))
        prefix = str(tmp_path / "m")
        jit.save(net, prefix,
                 input_spec=[jit.InputSpec([None, 1, 4, 4], "float32")])
        bias = np.asarray(net[1].bias.numpy())[0]
    finally:
        placement.set_default(prev)
    so = capi._build()
    # a copy of the module with go.mod, laid out as in the repository so
    # the cgo flags' relative paths hold
    top = tmp_path / "tree"
    shutil.copytree(GO_DIR, top / "paddle_tpu_torch" / "inference" / "go")
    shutil.copytree(capi.CSRC, top / "paddle_tpu_torch" / "inference"
                    / "csrc")
    (top / "build").mkdir()
    os.symlink(os.path.dirname(so), top / "build" / "paddle_tpu_torch_capi")
    go_dir = top / "paddle_tpu_torch" / "inference" / "go"
    env = dict(os.environ,
               CGO_LDFLAGS=" ".join(capi.python_link_flags()),
               PYTHONPATH=os.pathsep.join([ROOT] + site.getsitepackages()),
               LD_LIBRARY_PATH=os.path.dirname(so))
    env.pop(capi.DEVICE_ENV, None)
    subprocess.run(["go", "mod", "init", "paddle_tpu_torch/inference/go"],
                   cwd=go_dir, env=env, check=True, capture_output=True)
    r = subprocess.run(["go", "vet", "./..."], cwd=go_dir, env=env,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    exe = str(tmp_path / "example")
    r = subprocess.run(["go", "build", "-o", exe, "./example"],
                       cwd=go_dir, env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([exe, "-cpu", prefix, "1,1,4,4"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "output 0 shape=[1 10]" in r.stdout
    first = float(r.stdout.split("first=")[1].split()[0])
    np.testing.assert_allclose(first, bias, rtol=1e-5)   # zeros in
