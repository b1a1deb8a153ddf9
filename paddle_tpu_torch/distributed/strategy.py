"""DistributedStrategy (the counterpart of
``paddle_tpu/distributed/strategy.py``): the toggles and ``*_configs``
that ``SpmdTrainStep`` reads, and :func:`validate_toggles`.

The port carries every toggle of the JAX package's: data, tensor,
sequence and pipeline parallelism (``pipeline`` shapes the mesh; the
schedule is ``parallel.pipeline``'s), ZeRO 1-3 (``sharding``), the
gradient-communication stage (``grad_comm`` and its bf16 alias
``fp16_allreduce``), ``gradient_merge``, ``recompute`` and ``amp``
through ``SpmdTrainStep``, ``localsgd`` / ``adaptive_localsgd`` through
``fleet.get_train_step`` (``parallel.LocalSGDTrainStep``), and the
LAMB/LARS optimizer swaps.  As in the JAX package, ``dgc`` and
``a_sync`` raise, and so does ``pipeline_configs.schedule_mode =
'F-then-B'``.
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
class LocalSGDConfig:
    k_steps: int = 1
    begin_step: int = 1


@dataclass
class AdaptiveLocalSGDConfig:
    init_k_steps: int = 1
    begin_step: int = 1


@dataclass
class LambConfig:
    lamb_weight_decay: float = 0.01
    exclude_from_weight_decay: list = field(default_factory=list)


@dataclass
class LarsConfig:
    lars_coeff: float = 0.001
    lars_weight_decay: float = 0.0005
    epsilon: float = 0.0
    exclude_from_weight_decay: list = field(default_factory=list)


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
        "localsgd_configs": LocalSGDConfig,
        "adaptive_localsgd_configs": AdaptiveLocalSGDConfig,
        "sequence_parallel_configs": SequenceParallelConfig,
        "lamb_configs": LambConfig,
        "lars_configs": LarsConfig,
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
        self.lamb = False
        self.lars = False
        self.a_sync = False
        self.sequence_parallel = False
        self.fp16_allreduce = False
        self.find_unused_parameters = False
        # bucket size of the grad_comm stage: gradients fuse into flat
        # buckets of this many MB, each reduced by its own collectives
        self.fuse_grad_size_in_MB = 32
        # ordered (regex, spec) partition rules for the sharding plan
        # (distributed/sharding.py); None = placements + ZeRO-3 dim 0
        self.sharding_rules = None
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
            from ..core.enforce import InvalidArgumentError
            from .grad_comm import format_mesh_axes
            axes = format_mesh_axes(
                {MP_AXIS: mp, PP_AXIS: pp, SP_AXIS: sp}) or "none"
            raise InvalidArgumentError(
                f"DistributedStrategy: the model-parallel degrees "
                f"(mesh axes [{axes}], product {model}) do not divide "
                f"the device count ({n_devices}) — {n_devices % model} "
                f"device(s) would be silently dropped.  Pick degrees "
                f"whose product divides {n_devices}, or run on "
                f"{(n_devices // model) * model} devices.")
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


def validate_toggles(strategy: DistributedStrategy,
                     n_devices: Optional[int] = None) -> None:
    """Raise on a toggle the port does not carry (dgc, a_sync, the
    F-then-B schedule) and on knobs out of range; with ``n_devices``
    also on degrees that do not divide it."""
    from ..core.enforce import InvalidArgumentError
    if n_devices is not None:
        strategy.infer_mesh_shape(int(n_devices))
    fuse = strategy.fuse_grad_size_in_MB
    if not isinstance(fuse, (int, float)) or fuse <= 0:
        raise InvalidArgumentError(
            f"strategy.fuse_grad_size_in_MB={fuse!r}: the gradient "
            f"bucket size must be a positive number of megabytes — each "
            f"bucket is one fused collective, so 0 or negative would "
            f"mean no reduction at all.  Typical values: 8-64 (small = "
            f"more overlap opportunities, large = fewer collectives).")
    gc = strategy.grad_comm
    if gc.dtype not in (None, "fp32", "bf16", "int8"):
        raise InvalidArgumentError(
            f"strategy.grad_comm.dtype={gc.dtype!r}: wire dtype must be "
            f"None (off), 'fp32', 'bf16' or 'int8'.")
    if int(gc.block_size) <= 0:
        raise InvalidArgumentError(
            f"strategy.grad_comm.block_size={gc.block_size!r}: int8 "
            f"block-scaling needs a positive block size (one f32 absmax "
            f"scale per block; typical: 128-1024).")
    if float(gc.scatter_threshold_KB) < 0:
        raise InvalidArgumentError(
            f"strategy.grad_comm.scatter_threshold_KB="
            f"{gc.scatter_threshold_KB!r} must be >= 0 (buckets at least "
            f"this large take the reduce-scatter + all-gather route; "
            f"smaller take one fused sum).")
    from .grad_comm import OVERLAP_MODES
    if gc.overlap not in OVERLAP_MODES:
        raise InvalidArgumentError(
            f"strategy.grad_comm.overlap={gc.overlap!r}: must be 'none' "
            f"(comm strictly after backward — the measured no-overlap "
            f"baseline), 'auto' (each bucket's collectives issued "
            f"asynchronously as its last gradient lands) or 'ring' "
            f"(single-chunk permutations).")
    if strategy.fp16_allreduce and gc.dtype not in (None, "bf16"):
        raise InvalidArgumentError(
            f"strategy.fp16_allreduce is an alias for grad_comm.dtype="
            f"'bf16' but grad_comm.dtype={gc.dtype!r} is also set — "
            f"drop the alias or the explicit dtype; they conflict.")
    if gc.dtype is not None or strategy.fp16_allreduce:
        still_bad = [name for name, on in
                     (("pipeline", strategy.pipeline),
                      ("sequence_parallel", strategy.sequence_parallel))
                     if on]
        if still_bad:
            raise NotImplementedError(
                f"strategy.grad_comm + strategy."
                f"{' + strategy.'.join(still_bad)}: the explicit "
                f"grad-comm stage composes data parallelism with "
                f"tensor parallelism (mp-sharded params) and ZeRO-3 "
                f"(strategy.sharding stage 3, dp-sharded params), but "
                f"pipeline/sequence-parallel axes schedule cross-stage "
                f"collectives the stage cannot carry.  Disable grad_comm "
                f"(leave its dtype None) on pp/sp meshes, or drop the "
                f"pp/sp degrees.")
    if strategy.dgc:
        raise NotImplementedError(
            "strategy.dgc: deep gradient compression is not carried, as "
            "in paddle_tpu; the quantized gradient-collective stage "
            "(strategy.grad_comm.dtype='int8', block-scaled with error "
            "feedback) covers wire compression")
    if strategy.a_sync:
        raise NotImplementedError(
            "strategy.a_sync: async parameter-server training is not "
            "carried, as in paddle_tpu")
    sm = strategy.pipeline_configs.schedule_mode
    if sm not in ("1F1B", "F-then-B"):
        raise ValueError(
            f"pipeline_configs.schedule_mode must be '1F1B' or "
            f"'F-then-B' (section_worker.cc:115-127), got {sm!r}")
    if strategy.pipeline and sm == "F-then-B":
        raise NotImplementedError(
            "pipeline_configs.schedule_mode='F-then-B': the pipeline "
            "(parallel/pipeline.py) differentiates one fill-drain "
            "schedule, which collapses the F-then-B/1F1B distinction — "
            "the backward schedule is derived by autodiff and in-flight "
            "state is O(microbatch) either way.  There is no separate "
            "all-forwards-then-all-backwards executor to select, so this "
            "knob cannot take effect; keep the default '1F1B'.")
