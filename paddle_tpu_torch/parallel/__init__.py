"""paddle_tpu_torch.parallel: data, tensor and sequence parallelism over
the mesh of :mod:`..distributed` (the tensor-parallel layers on the
fused collective matmuls, ring attention, DataParallel and
SpmdTrainStep), and activation recompute."""
from . import data_parallel, ring_attention, spmd_train_step, tp_layers  # noqa: F401
from .data_parallel import DataParallel  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401
from .ring_attention import reference_attention, ring_attention  # noqa: F401
from .spmd_train_step import SpmdTrainStep  # noqa: F401
from .tp_layers import (ColumnParallelLinear,  # noqa: F401
                        ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding, get_placement,
                        mark_placement, set_placement, split)
