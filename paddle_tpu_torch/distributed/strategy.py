"""DistributedStrategy (the counterpart of
``paddle_tpu/distributed/strategy.py``): the toggles and ``*_configs``
that ``SpmdTrainStep`` reads, and :func:`validate_toggles`.

This slice ports data, tensor and sequence parallelism.  A toggle whose
machinery is not ported yet raises ``NotImplementedError`` naming it,
never a silent no-op: ``sharding`` (ZeRO), ``grad_comm`` /
``fp16_allreduce``, ``gradient_merge``, ``recompute``, ``amp`` (use
``amp.decorate`` on the model and optimizer), ``pipeline``,
``localsgd`` / ``adaptive_localsgd``, and, as in the JAX package,
``dgc`` and ``a_sync``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["DistributedStrategy", "validate_toggles"]


@dataclass
class AMPConfig:
    init_loss_scaling: float = 32768.0
    incr_every_n_steps: int = 1000
    decr_every_n_nan_or_inf: int = 2
    incr_ratio: float = 2.0
    decr_ratio: float = 0.5
    use_dynamic_loss_scaling: bool = True
    custom_white_list: list = field(default_factory=list)
    custom_black_list: list = field(default_factory=list)
    use_pure_fp16: bool = False
    dtype: str = "bfloat16"


@dataclass
class RecomputeConfig:
    checkpoints: list = field(default_factory=list)
    enable_offload: bool = False


@dataclass
class ShardingConfig:
    sharding_degree: int = 8
    stage: int = 2
    fuse_broadcast_MB: float = 32.0
    hybrid_dp: bool = False
    min_shard_numel: int = 1024


@dataclass
class PipelineConfig:
    micro_batch_size: int = 1
    accumulate_steps: int = 1
    schedule_mode: str = "1F1B"
    pp_degree: int = 1


@dataclass
class TensorParallelConfig:
    tensor_parallel_degree: int = 1
    tensor_init_seed: int = -1


@dataclass
class GradientMergeConfig:
    k_steps: int = 1
    avg: bool = True


@dataclass
class SequenceParallelConfig:
    sp_degree: int = 1
    ring_attention: bool = True


@dataclass
class GradCommConfig:
    dtype: Optional[str] = None       # None=off | 'fp32' | 'bf16' | 'int8'
    block_size: int = 256
    error_feedback: bool = True
    scatter_threshold_KB: float = 32.0
    overlap: str = "auto"


class DistributedStrategy:
    """fleet.DistributedStrategy parity: bool toggles and nested
    ``*_configs`` (a dict assigned to a config sets its fields)."""

    _CONFIGS = {
        "amp_configs": AMPConfig,
        "recompute_configs": RecomputeConfig,
        "sharding_configs": ShardingConfig,
        "pipeline_configs": PipelineConfig,
        "tensor_parallel_configs": TensorParallelConfig,
        "gradient_merge_configs": GradientMergeConfig,
        "sequence_parallel_configs": SequenceParallelConfig,
        "grad_comm": GradCommConfig,
    }

    def __init__(self):
        self.amp = False
        self.recompute = False
        self.sharding = False
        self.pipeline = False
        self.tensor_parallel = False
        self.gradient_merge = False
        self.localsgd = False
        self.adaptive_localsgd = False
        self.dgc = False
        self.a_sync = False
        self.sequence_parallel = False
        self.fp16_allreduce = False
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        for name, cls in self._CONFIGS.items():
            object.__setattr__(self, "_" + name, cls())

    def __getattr__(self, name):
        if name in DistributedStrategy._CONFIGS:
            return getattr(self, "_" + name)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._CONFIGS:
            cfg = self._CONFIGS[name]()
            if isinstance(value, dict):
                for k, v in value.items():
                    if hasattr(cfg, k):
                        setattr(cfg, k, v)
            else:
                cfg = value
            object.__setattr__(self, "_" + name, cfg)
        else:
            object.__setattr__(self, name, value)

    def infer_mesh_shape(self, n_devices: int) -> Dict[str, int]:
        """The mesh {axis: size} this strategy implies over
        ``n_devices`` ranks; the model-parallel degrees must divide it."""
        from .mesh import DP_AXIS, MP_AXIS, PP_AXIS, SP_AXIS
        mp = (self.tensor_parallel_configs.tensor_parallel_degree
              if self.tensor_parallel else 1)
        pp = self.pipeline_configs.pp_degree if self.pipeline else 1
        sp = (self.sequence_parallel_configs.sp_degree
              if self.sequence_parallel else 1)
        model = mp * pp * sp
        if n_devices % model:
            raise ValueError(
                f"DistributedStrategy: the model-parallel degrees (mp {mp}, "
                f"pp {pp}, sp {sp}; product {model}) do not divide the "
                f"device count {n_devices}")
        shape: Dict[str, int] = {}
        if pp > 1:
            shape[PP_AXIS] = pp
        shape[DP_AXIS] = max(n_devices // model, 1)
        if sp > 1:
            shape[SP_AXIS] = sp
        if mp > 1:
            shape[MP_AXIS] = mp
        return shape

    def __repr__(self):
        on = [k for k, v in self.__dict__.items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on})"


_NOT_PORTED = (
    ("sharding", "ZeRO sharding of optimizer state, gradients and "
                 "parameters"),
    ("gradient_merge", "in-step micro-batch accumulation"),
    ("recompute", "activation recompute"),
    ("amp", "mixed precision through the strategy (use amp.decorate "
            "on the model and optimizer)"),
    ("fp16_allreduce", "the bf16-wire gradient reduction"),
    ("pipeline", "pipeline parallelism"),
    ("localsgd", "LocalSGD"),
    ("adaptive_localsgd", "adaptive LocalSGD"),
)


def validate_toggles(strategy: DistributedStrategy,
                     n_devices: Optional[int] = None) -> None:
    """Raise on a toggle this port does not carry; with ``n_devices``
    also on degrees that do not divide it."""
    if n_devices is not None:
        strategy.infer_mesh_shape(int(n_devices))
    fuse = strategy.fuse_grad_size_in_MB
    if not isinstance(fuse, (int, float)) or fuse <= 0:
        raise ValueError(f"strategy.fuse_grad_size_in_MB={fuse!r}: must be "
                         f"a positive number of megabytes")
    for name, what in _NOT_PORTED:
        if getattr(strategy, name):
            raise NotImplementedError(
                f"strategy.{name}: {what} is not ported to "
                f"paddle_tpu_torch yet")
    if strategy.grad_comm.dtype is not None:
        raise NotImplementedError(
            f"strategy.grad_comm (dtype={strategy.grad_comm.dtype!r}): the "
            f"explicit gradient-communication stage is not ported yet; "
            f"leave grad_comm.dtype None for the plain all-reduce")
    if strategy.dgc:
        raise NotImplementedError(
            "strategy.dgc: deep gradient compression is not carried, as "
            "in paddle_tpu")
    if strategy.a_sync:
        raise NotImplementedError(
            "strategy.a_sync: async parameter-server training is not "
            "carried, as in paddle_tpu")
