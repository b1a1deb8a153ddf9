"""paddle_tpu_torch.parallel: data, tensor, sequence and pipeline
parallelism over the mesh of :mod:`..distributed` (the tensor-parallel
layers on the fused collective matmuls, ring attention, the fill-drain
pipeline, DataParallel, SpmdTrainStep and LocalSGD), the row-sharded
embedding, and activation recompute."""
from . import (data_parallel, localsgd, pipeline, ring_attention,  # noqa
               sharded_embedding, spmd_train_step, tp_layers)
from .data_parallel import DataParallel  # noqa: F401
from .localsgd import LocalSGDTrainStep  # noqa: F401
from .pipeline import (Pipeline, PipelineStage, pipelined_fn,  # noqa: F401
                       pipeline_train_fn, stack_stage_params)
from .recompute import recompute, recompute_sequential  # noqa: F401
from .ring_attention import (reference_attention, ring_attention,  # noqa
                             ring_attention_per_device)
from .sharded_embedding import ShardedEmbedding  # noqa: F401
from .spmd_train_step import SpmdTrainStep  # noqa: F401
from .tp_layers import (ColumnParallelLinear,  # noqa: F401
                        ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding, get_placement,
                        mark_placement, set_placement, split)
