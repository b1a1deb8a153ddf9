"""Learning rates (paddle_tpu.optimizer.lr).  This slice takes a float
learning rate only, read by ``Optimizer.get_lr()``; the ``LRScheduler``
family is not ported yet (ROADMAP A3)."""
