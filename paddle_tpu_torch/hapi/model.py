"""``paddle.Model`` (the counterpart of ``paddle_tpu/hapi/model.py``;
reference: python/paddle/hapi/model.py:810)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.tensor import to_tensor
from ..io import DataLoader, Dataset
from ..jit.train_step import TrainStep
from ..metric import Metric
from .callbacks import config_callbacks


class Model:
    """High-level trainer: prepare → fit/evaluate/predict → save/load."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step: Optional[TrainStep] = None
        self.stop_training = False

    # -- setup -------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit_compile=True):
        """reference: hapi/model.py:1640.  ``jit_compile=True`` trains
        through one :class:`~..jit.TrainStep` (forward, backward, clip and
        update as one call); ``False`` through the eager tape
        (``backward``, ``step``, ``clear_grad``).  ``loss`` may return a
        list or tuple of losses (multi-task heads); they are summed for
        the update and reported summed.  ``amp_configs`` is accepted and
        ignored, as in paddle_tpu (decorate the model with
        ``amp.decorate`` before)."""
        self._optimizer = optimizer
        self._loss = _wrap_loss(loss) if loss is not None else None
        metrics = metrics or []
        self._metrics = metrics if isinstance(metrics, list) else [metrics]
        self._jit = jit_compile
        if optimizer is not None and loss is not None and jit_compile:
            n_in = (len(self._inputs)
                    if isinstance(self._inputs, (list, tuple)) else 1)
            self._train_step = TrainStep(self.network, self._loss,
                                         optimizer, n_inputs=n_in)

    # -- data plumbing -----------------------------------------------------
    def _to_loader(self, data, batch_size, shuffle, num_workers=0):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers)
        return data  # an iterable of batches

    def _split_batch(self, batch):
        """A loader batch as (inputs, labels): by the declared
        ``inputs=`` when given (multi-input models), else input*,
        label."""
        if isinstance(batch, (list, tuple)):
            if isinstance(self._inputs, (list, tuple)):
                k = len(self._inputs)
                return batch[:k], batch[k:]
            if len(batch) >= 2:
                return batch[:-1], batch[-1:]
            return batch, ()
        return (batch,), ()

    # -- training ----------------------------------------------------------
    def train_batch(self, inputs, labels=None):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = (labels if isinstance(labels, (list, tuple))
                  else ([labels] if labels is not None else []))
        inputs = [_t(i) for i in inputs]
        labels = [_t(lb) for lb in labels]
        if self._train_step is not None:
            self._train_step.n_inputs = len(inputs)
            loss = self._train_step(*inputs, *labels)
        else:
            loss = self._loss(self.network(*inputs), *labels)
            loss.backward()
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [float(loss)]

    def eval_batch(self, inputs, labels=None):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = (labels if isinstance(labels, (list, tuple))
                  else ([labels] if labels is not None else []))
        labels = [_t(lb) for lb in labels]
        with torch.no_grad():
            out = self.network(*[_t(i) for i in inputs])
            loss = (self._loss(out, *labels)
                    if self._loss and labels else None)
        metrics = []
        for m in self._metrics:
            res = m.compute(out, *labels)
            m.update(res)
            metrics.append(m.accumulate())
        return ([float(loss)] if loss is not None else []), metrics, out

    def predict_batch(self, inputs):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        was = self.network.training
        self.network.eval()
        with torch.no_grad():
            out = self.network(*[_t(i) for i in inputs])
        if was:
            self.network.train()
        return out

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None):
        """reference: hapi/model.py:1299."""
        loader = self._to_loader(train_data, batch_size, shuffle,
                                 num_workers)
        eval_loader = self._to_loader(eval_data, batch_size, False,
                                      num_workers)
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, verbose=verbose,
                                metrics=[m.name() for m in self._metrics])
        if save_dir:
            from .callbacks import ModelCheckpoint
            cbks.callbacks.append(ModelCheckpoint(save_freq, save_dir))
            cbks.callbacks[-1].set_model(self)
        self.stop_training = False
        cbks.on_train_begin()
        history = {"loss": []}
        logs = {}
        try:
            for epoch in range(epochs):
                self.network.train()
                cbks.on_epoch_begin(epoch)
                logs = {}
                for step, batch in enumerate(loader):
                    cbks.on_train_batch_begin(step)
                    ins, labs = self._split_batch(batch)
                    loss = self.train_batch(list(ins), list(labs))
                    logs = {"loss": loss[0]}
                    if step % max(log_freq, 1) == 0:
                        cbks.on_train_batch_end(step, logs)
                history["loss"].append(logs.get("loss"))
                cbks.on_epoch_end(epoch, logs)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(eval_loader, verbose=0,
                                              _callbacks=cbks)
                    cbks.on_eval_end(eval_logs)
                if self.stop_training:
                    break
        finally:
            # even when training raises: callbacks holding process-wide
            # resources (Checkpoint's SIGTERM handler) release them
            cbks.on_train_cleanup()
        cbks.on_train_end(logs)
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _callbacks=None):
        loader = self._to_loader(eval_data, batch_size, False, num_workers)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            ins, labs = self._split_batch(batch)
            loss, _, _ = self.eval_batch(list(ins), list(labs))
            if loss:
                losses.append(loss[0])
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            name = m.name()
            if isinstance(name, list):
                logs.update(dict(zip(name, m.accumulate())))
            else:
                logs[name] = m.accumulate()
        self.network.train()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = self._to_loader(test_data, batch_size, False, num_workers)
        outputs = []
        for batch in loader:
            ins, _ = (self._split_batch(batch)
                      if isinstance(batch, (list, tuple)) else ((batch,), ()))
            outputs.append(self.predict_batch(list(ins)))
        if stack_outputs and outputs and isinstance(outputs[0],
                                                    torch.Tensor):
            return [np.concatenate([o.numpy() for o in outputs])]
        return outputs

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        """``training=True``: the parameters (``.pdparams``) and the
        optimizer's state (``.pdopt``); ``False``: the inference artifact
        of ``jit.save`` for the declared ``inputs``."""
        from .. import framework_io
        if training:
            framework_io.save(self.network.state_dict(), path + ".pdparams")
            if self._optimizer is not None:
                framework_io.save(self._optimizer.state_dict(),
                                  path + ".pdopt")
        else:
            from .. import jit
            jit.save(self.network, path, input_spec=self._inputs)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from .. import framework_io
        from ..utils import fs
        self.network.set_state_dict(framework_io.load(path + ".pdparams"))
        if (not reset_optimizer and self._optimizer is not None
                and fs.exists(path + ".pdopt")):
            self._optimizer.set_state_dict(
                framework_io.load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from . import summary as _summary
        return _summary(self.network, input_size)


def _t(x):
    """A batch leaf as a Tensor (arrays and numbers copied to the default
    device)."""
    return x if isinstance(x, torch.Tensor) else to_tensor(np.asarray(x))


def _wrap_loss(loss):
    """Multi-loss support: a loss returning a list/tuple is summed
    (reference: hapi/model.py _run_one_epoch sums loss lists)."""
    def fn(out, *labels):
        val = loss(out, *labels)
        if isinstance(val, (list, tuple)):
            total = val[0]
            for v in val[1:]:
                total = total + v
            return total
        return val
    fn.__name__ = getattr(loss, "__name__", "loss")
    return fn
