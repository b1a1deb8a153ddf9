"""Worker script of ``test_torch_multihost.py``: one rank of a
``torch.distributed`` job (gloo, on the CPU) that
``paddle_tpu_torch.distributed.launch`` started.  It checks the
rendezvous environment, sums the ranks over the group, and trains two
data-parallel Adam steps of the test's MLP on its half of the batch;
rank 0 writes the global losses (the mean of the ranks') to
``$OUT_DIR/losses.json``.  It imports torch and the port only."""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import paddle_tpu_torch as paddle  # noqa: E402
import paddle_tpu_torch.nn.functional as F  # noqa: E402
from paddle_tpu_torch import distributed as dist  # noqa: E402
from paddle_tpu_torch import nn, optimizer  # noqa: E402


def main():
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    dist.init_parallel_env(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 2 and rank == int(os.environ["PADDLE_TRAINER_ID"])
    assert int(os.environ["WORLD_SIZE"]) == 2
    t = torch.tensor([float(rank)])
    dist.all_reduce(t)
    assert float(t) == 1.0, float(t)

    data = np.load(os.path.join(os.environ["OUT_DIR"], "inputs.npz"))
    net = nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.Linear(16, 4))
    with torch.no_grad():
        for i, p in enumerate(net.parameters()):
            p.copy_(torch.from_numpy(data[f"w{i}"]))
    model = paddle.DataParallel(net)
    opt = optimizer.Adam(learning_rate=0.01, parameters=net.parameters())
    x = paddle.to_tensor(data["x"][rank * 4:(rank + 1) * 4], place="cpu")
    y = paddle.to_tensor(data["y"][rank * 4:(rank + 1) * 4], place="cpu")
    losses = []
    for _ in range(2):
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        g = loss.detach().clone().reshape([1])
        dist.all_reduce(g)
        losses.append(float(g) / world)
    if rank == 0:
        with open(os.path.join(os.environ["OUT_DIR"], "losses.json"),
                  "w") as f:
            json.dump(losses, f)


if __name__ == "__main__":
    main()
