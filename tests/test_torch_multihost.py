"""The multi-process bootstrap held to paddle_tpu (the training leg of
``tests/test_multihost.py``): ``paddle_tpu_torch.distributed.launch``
starts 2 gloo ranks of ``torch_multihost_worker.py`` with the
``torch.distributed`` rendezvous (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) where paddle_tpu sets its JAX
coordinator; a collective crosses the process boundary, and two
data-parallel Adam steps on half a batch each give the losses of
paddle_tpu's one-process ``TrainStep`` on the whole batch (rtol 1e-5:
the ranks' halves are summed in another order).  The CLI form, a
failing rank ending the rest, and the job's timeout are held too.  The
dataset GlobalShuffle leg is ROADMAP A6's ``io``."""
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np

from paddle_tpu_torch.distributed.launch import free_port, launch

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multihost_worker.py")


def _oracle():
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as F
    from paddle_tpu import nn, optimizer
    from paddle_tpu.jit import TrainStep
    paddle.seed(7)
    net = nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.Linear(16, 4))
    init = [np.asarray(p.data).copy() for p in net.parameters()]
    r = np.random.RandomState(7)
    x = r.randn(8, 8).astype(np.float32)
    y = r.randint(0, 4, (8,)).astype(np.int64)
    opt = optimizer.Adam(learning_rate=0.01, parameters=net.parameters())
    step = TrainStep(net, lambda o, lab: F.cross_entropy(o, lab), opt)
    expect = [float(step(jnp.asarray(x), jnp.asarray(y.astype(np.int32))))
              for _ in range(2)]
    return init, x, y, expect


def test_two_process_bootstrap_and_training(tmp_path):
    init, x, y, expect = _oracle()
    np.savez(tmp_path / "inputs.npz", x=x, y=y,
             **{f"w{i}": w for i, w in enumerate(init)})
    old = os.environ.get("OUT_DIR")
    os.environ["OUT_DIR"] = str(tmp_path)
    try:
        rc = launch(WORKER, nproc_per_node=2, master_port=free_port(),
                    log_dir=str(tmp_path / "logs"), timeout=240)
    finally:
        if old is None:
            os.environ.pop("OUT_DIR")
        else:
            os.environ["OUT_DIR"] = old
    logs = "".join(p.read_text() for p in (tmp_path / "logs").glob("*"))
    assert rc == 0, logs
    got = json.loads((tmp_path / "losses.json").read_text())
    np.testing.assert_allclose(got, expect, rtol=1e-5)


def test_cli_failing_rank_ends_the_rest_and_timeout(tmp_path):
    """``python -m paddle_tpu_torch.distributed.launch``: a rank that
    exits 3 ends its sleeping peer and the launcher returns 3; a job
    past ``--timeout`` is ended with 124."""
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(float(sys.argv[1]))\n")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--master_port", str(free_port())]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    t0 = time.monotonic()
    p = subprocess.run(cmd + [str(script), "120"], env=env, timeout=100)
    assert p.returncode == 3 and time.monotonic() - t0 < 60
    script.write_text("import time\ntime.sleep(120)\n")
    p = subprocess.run(cmd + ["--timeout", "2", str(script)], env=env,
                       timeout=100)
    assert p.returncode == 124


def test_launch_multi_host_ranks_and_env(tmp_path):
    """``--ips``/``--node_rank``: this host's ranks are ``node_rank *
    nproc_per_node + local`` of ``len(ips) * nproc_per_node``, and the
    first host is the master."""
    script = tmp_path / "env.py"
    script.write_text(
        "import json, os\n"
        "keys = ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'MASTER_ADDR',\n"
        "        'MASTER_PORT', 'PADDLE_TRAINER_ID')\n"
        "open(os.path.join(os.environ['OUT_DIR'], os.environ['RANK']),\n"
        "     'w').write(json.dumps({k: os.environ[k] for k in keys}))\n")
    old = os.environ.get("OUT_DIR")
    os.environ["OUT_DIR"] = str(tmp_path)
    try:
        rc = launch(str(script), nproc_per_node=2, ips="10.0.0.1,10.0.0.2",
                    node_rank=1, master_port=7000)
    finally:
        if old is None:
            os.environ.pop("OUT_DIR")
        else:
            os.environ["OUT_DIR"] = old
    assert rc == 0
    for rank, local in ((2, 0), (3, 1)):
        env = json.loads((tmp_path / str(rank)).read_text())
        assert env == {"RANK": str(rank), "LOCAL_RANK": str(local),
                       "WORLD_SIZE": "4", "MASTER_ADDR": "10.0.0.1",
                       "MASTER_PORT": "7000",
                       "PADDLE_TRAINER_ID": str(rank)}
