"""paddle_tpu_torch's C ABI (``inference/capi.py``,
``inference/csrc/{predictor_capi.cpp,paddle_tpu_capi.h}``) held to
paddle_tpu's on the CPU.

- the ctypes round trip (``CPredictor``) against the in-process
  Predictor and the model run eagerly;
- the two C ABIs (paddle_tpu's and the port's) on one artifact's
  weights, saved by each package: outputs within 1e-6; float32 ids into
  an int64 program through the port's, against paddle_tpu's Predictor;
- an external C program (no Python in ``main``) with the CPU asked for
  explicitly (``PADDLE_TPU_TORCH_CAPI_DEVICE=cpu``): its checksum
  against the in-process Predictor within 1e-4 relative;
- a fresh process loads the shim and serves with neither ``jax`` nor
  ``paddle_tpu`` imported;
- with no GPU and no request for the CPU, ``PT_NewPredictor`` returns
  NULL and prints the placement error (also from the C program).
"""
import os
import site
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import inference, jit, nn
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.inference import capi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    monkeypatch.setenv(capi.DEVICE_ENV, "cpu")
    yield
    placement.set_default(prev)


def _child_env(**extra):
    """An environment whose embedded or child interpreter imports the
    port (and torch) from this checkout and this interpreter's
    site-packages."""
    paths = [ROOT] + site.getsitepackages()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", capi.DEVICE_ENV)}
    env["PYTHONPATH"] = os.pathsep.join(paths)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """An MLP and an embedding (int64 ids) saved by both packages from
    the same weights: {name: (jax prefix, port prefix, input)}."""
    d = tmp_path_factory.mktemp("capi")
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    out = {}
    try:
        for name, make, spec, x in (
                ("mlp", lambda nn_: nn_.Sequential(
                    nn_.Linear(8, 16), nn_.ReLU(), nn_.Linear(16, 4)),
                 ([None, 8], "float32"),
                 np.random.RandomState(1).randn(3, 8).astype(np.float32)),
                ("embedding", lambda nn_: nn_.Embedding(50, 6),
                 ([None, 5], "int64"),
                 np.random.RandomState(2).randint(0, 50, (4, 5)))):
            paddle_tpu.seed(91)
            ref = make(paddle_tpu.nn)
            jpfx = str(d / f"jax_{name}")
            paddle_tpu.jit.save(ref, jpfx, input_spec=[
                paddle_tpu.jit.InputSpec(*spec)])
            model = make(nn)
            model.set_state_dict({k: np.array(v.numpy())
                                  for k, v in ref.state_dict().items()})
            tpfx = str(d / f"port_{name}")
            jit.save(model, tpfx, input_spec=[jit.InputSpec(*spec)])
            out[name] = (jpfx, tpfx, x, np.asarray(
                ref(paddle_tpu.to_tensor(x)).numpy()))
    finally:
        placement.set_default(prev)
    return out


def test_capi_ctypes_roundtrip(saved):
    _, pfx, x, want = saved["mlp"]
    pred = inference.create_predictor(inference.Config(pfx))
    with capi.CPredictor(pfx) as p:
        out = p.run([x])
        assert len(out) == 1 and out[0].dtype == np.float32
        np.testing.assert_allclose(out[0], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(out[0], np.asarray(pred.run([x])[0]))
        out2 = p.run([x[:1] * 2])           # another batch size
        np.testing.assert_array_equal(
            out2[0], np.asarray(pred.run([x[:1] * 2])[0]))


def test_two_c_abis_agree(saved):
    """paddle_tpu's C ABI over its artifact and the port's over its own,
    from the same weights."""
    from paddle_tpu.inference.capi import CPredictor as JaxCPredictor
    jpfx, tpfx, x, _ = saved["mlp"]
    ja = JaxCPredictor(jpfx)
    try:
        want = ja.run([x])
    finally:
        ja.close()
    with capi.CPredictor(tpfx) as p:
        got = p.run([x])
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


def test_float32_ids_into_an_int64_program(saved):
    """Token ids go into the port's C ABI as float32 and its Predictor
    casts them to the program's int64 (paddle_tpu's C ABI refuses them:
    its exported program checks the dtype), equal to paddle_tpu's
    Predictor fed the int64 ids."""
    jpfx, tpfx, ids, _ = saved["embedding"]
    jp = paddle_tpu.inference.create_predictor(
        paddle_tpu.inference.Config(jpfx))
    want = np.asarray(jp.run([ids])[0])
    with capi.CPredictor(tpfx) as p:
        got = p.run([ids.astype(np.float32)])
    assert got[0].shape == want.shape == (4, 5, 6)
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-6)


_C_MAIN = r"""
#include <stdio.h>
#include "paddle_tpu_capi.h"

int main(int argc, char** argv) {
  PT_Predictor* p = PT_NewPredictor(argv[1]);
  if (!p) { printf("FAIL new\n"); return 1; }
  float x[3 * 8];
  for (int i = 0; i < 24; ++i) x[i] = (float)i * 0.1f;
  const float* inputs[1] = {x};
  int64_t shape[2] = {3, 8};
  const int64_t* shapes[1] = {shape};
  int32_t ndims[1] = {2};
  int32_t n = PT_PredictorRun(p, inputs, shapes, ndims, 1);
  if (n != 1) { printf("FAIL run %d\n", n); return 1; }
  PT_Output out;
  if (PT_GetOutput(p, 0, &out) != 0) { printf("FAIL out\n"); return 1; }
  double sum = 0;
  for (int64_t i = 0; i < out.numel; ++i) sum += out.data[i];
  printf("OK shape=%lldx%lld sum=%.6f\n", (long long)out.shape[0],
         (long long)out.shape[1], sum);
  PT_FreeOutput(&out);
  PT_DeletePredictor(p);
  return 0;
}
"""


def _c_program(tmp_path):
    so = capi._build()
    c = tmp_path / "main.c"
    exe = tmp_path / "main"
    c.write_text(_C_MAIN)
    subprocess.run(["gcc", str(c), f"-I{capi.CSRC}", "-o", str(exe), so,
                    f"-Wl,-rpath,{os.path.dirname(so)}",
                    *capi.python_link_flags()],
                   check=True, capture_output=True)
    return str(exe)


def test_capi_from_external_c_program(saved, tmp_path):
    _, pfx, _, _ = saved["mlp"]
    exe = _c_program(tmp_path)
    r = subprocess.run([exe, pfx], capture_output=True, text=True,
                       env=_child_env(**{capi.DEVICE_ENV: "cpu"}),
                       timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr[-800:])
    assert r.stdout.startswith("OK shape=3x4"), r.stdout
    xin = (np.arange(24, dtype=np.float32) * 0.1).reshape(3, 8)
    pred = inference.create_predictor(inference.Config(pfx))
    expect = float(np.asarray(pred.run([xin])[0]).astype(np.float64).sum())
    got = float(r.stdout.strip().split("sum=")[1])
    np.testing.assert_allclose(got, expect, rtol=1e-4)


def test_fresh_process_serves_without_jax(saved):
    _, pfx, x, want = saved["mlp"]
    code = ("import sys, numpy as np\n"
            "from paddle_tpu_torch.inference.capi import CPredictor\n"
            f"x = np.array({x.tolist()!r}, np.float32)\n"
            f"p = CPredictor({pfx!r})\n"
            "out = p.run([x])[0]\n"
            "p.close()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'paddle_tpu.')) or "
            "m == 'paddle_tpu')\n"
            "assert not bad, bad\n"
            "print(repr(out.tolist()))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=_child_env(**{capi.DEVICE_ENV: "cpu"}),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = np.array(eval(r.stdout.strip().splitlines()[-1]), np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    src = open(os.path.join(capi.CSRC, "predictor_capi.cpp")).read()
    assert "jax" not in src and '"paddle_tpu.' not in src


def test_no_gpu_and_no_cpu_request_returns_null(saved, tmp_path):
    _, pfx, _, _ = saved["mlp"]
    # one process, the switch unset, "gpu" and a bad value in turn (the
    # shim reads the environment at each PT_NewPredictor)
    code = ("import os, sys\n"
            "from paddle_tpu_torch.inference.capi import DEVICE_ENV, "
            "load_capi\n"
            "lib = load_capi()\n"
            "for v in (None, 'gpu', 'tpu'):\n"
            "    if v is not None:\n"
            "        os.environ[DEVICE_ENV] = v\n"
            f"    h = lib.PT_NewPredictor({pfx!r}.encode())\n"
            "    sys.stderr.write(f'=== {v} ===\\n'); sys.stderr.flush()\n"
            "    print(v, h)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=_child_env(CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["None", "None", "gpu", "None", "tpu",
                                "None"], r.stdout
    err = r.stderr.split("=== ")
    assert "no CUDA device" in err[0] and "no CUDA device" in err[1]
    assert "want cpu or gpu" in err[2], r.stderr[-2000:]
    exe = _c_program(tmp_path)
    r = subprocess.run([exe, pfx], capture_output=True, text=True,
                       env=_child_env(CUDA_VISIBLE_DEVICES=""),
                       timeout=300)
    assert r.returncode == 1 and r.stdout.startswith("FAIL new"), r.stdout
    assert "no CUDA device" in r.stderr
