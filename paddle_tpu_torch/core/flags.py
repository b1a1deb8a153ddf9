"""Global flags registry (``paddle_tpu.core.flags``): the JAX package's
47 flags, each with its name and default.

Flags may be seeded from the environment with the ``FLAGS_`` prefix,
as in the reference's gflags passthrough, and are read with
:func:`get_flag` / :func:`get_flags` and set with :func:`set_flags`.

A flag whose subject is an XLA or TPU setting has no counterpart on the
card (``CARD_LESS``): it is defined with its default, and setting it to
anything else, by :func:`set_flags` or from the environment, raises a
``ValueError`` that names it.  Flags whose subject the port has not
reached yet (the data loader, the fleet, the observability stack) are
stored and read back and change nothing.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict

__all__ = ["define_flag", "get_flag", "get_flags", "set_flags",
           "CARD_LESS"]


@dataclass
class _FlagDef:
    name: str
    default: Any
    help: str
    parser: Callable[[str], Any]


_registry: Dict[str, _FlagDef] = {}
_values: Dict[str, Any] = {}
_lock = threading.Lock()

# flags whose subject is an XLA or TPU setting: only their default holds
CARD_LESS = frozenset((
    "matmul_precision", "allocator_strategy", "pallas_attention_min_seqlen",
    "pallas_attention_dropout_min_seqlen", "pallas_interpret",
    "xla_latency_hiding", "static_donate", "compile_cache_dir"))


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


def _check(name: str, value: Any) -> None:
    if name in CARD_LESS and value != _registry[name].default:
        raise ValueError(
            f"FLAGS_{name}={value!r}: this flag sets XLA or the TPU and "
            f"has no counterpart on the card; only its default "
            f"{_registry[name].default!r} is taken")


def define_flag(name: str, default: Any, help: str = "") -> None:
    if isinstance(default, bool):
        parser: Callable[[str], Any] = _parse_bool
    elif isinstance(default, int):
        parser = int
    elif isinstance(default, float):
        parser = float
    else:
        parser = str
    with _lock:
        _registry[name] = _FlagDef(name, default, help, parser)
        env = os.environ.get(f"FLAGS_{name}")
        if env is not None:
            _check(name, parser(env))
            _values[name] = parser(env)
        else:
            _values.setdefault(name, default)


def get_flag(name: str) -> Any:
    if name not in _registry:
        raise KeyError(f"Unknown flag: {name}")
    return _values[name]


def set_flags(flags: Dict[str, Any]) -> None:
    """``paddle.set_flags``: names with or without ``FLAGS_``."""
    for k, v in flags.items():
        k = k.replace("FLAGS_", "")
        if k not in _registry:
            raise KeyError(f"Unknown flag: {k}")
        _check(k, v)
        with _lock:
            _values[k] = v


def get_flags(names=None) -> Dict[str, Any]:
    """``paddle.get_flags``: every flag, or the ones named (a name or a
    list), keyed without ``FLAGS_``."""
    if names is None:
        return dict(_values)
    if isinstance(names, str):
        names = [names]
    return {n.replace("FLAGS_", ""): get_flag(n.replace("FLAGS_", ""))
            for n in names}


_LATER = "Stored; no effect in the port yet (its subject is not ported)."

define_flag("check_nan_inf", False,
            "Scan every op output for NaN/Inf (reference: flags.cc:44). "
            + _LATER)
define_flag("benchmark", False,
            "Synchronise after each op and log timings (reference: "
            "flags.cc:38). " + _LATER)
define_flag("eager_delete_tensor_gb", 0.0,
            "Accepted for parity; the CUDA caching allocator owns buffer "
            "lifetimes.")
define_flag("use_pallas_kernels", True,
            "The hand-written kernel tier (the name is paddle_tpu's, so "
            "scripts and FLAGS_ environment variables carry across): the "
            "static Executor's epilogue-fusion pass and fused Adam, "
            "flash attention, the chunk matmul and the paged decode "
            "kernel.  On the CPU the tier runs the kernels' plain "
            "versions.")
define_flag("matmul_precision", "default",
            "jax's matmul precision (XLA).")
define_flag("allocator_strategy", "xla",
            "The XLA/TPU runtime's allocator.")
define_flag("profile_dir", "",
            "If set, profiler traces are written here. " + _LATER)
define_flag("pallas_attention_min_seqlen", 1024,
            "The TPU's flash-attention length threshold (the card's gate "
            "has none).")
define_flag("static_verify", False,
            "Run static.analysis verification (def-use, cross-program "
            "leaks, shape/dtype drift, name collisions, dead code and "
            "the hazards) on each Program version before the Executor "
            "first builds it, and record file:line anchors for every op "
            "at record time.  Off by default: verification replays "
            "every op on meta tensors once.")
define_flag("shard_verify", False,
            "Run the shardcheck SPMD safety passes "
            "(Program.verify(sharding=plan)) once per plan before the "
            "static Executor's first sharded build.")
define_flag("static_anchors", False,
            "Record a file:line source anchor on every op Program.record "
            "appends (one frame walk per recorded op, no verification), "
            "so Program.analyze() reports and diagnostics carry the "
            "user's source line.")
define_flag("static_donate", True,
            "XLA buffer donation of the static Executor's compiled step "
            "(the port's Executor updates its state in place).")
define_flag("profiler_sync_ops", False,
            "Profiler op timing blocks on device completion per op. "
            + _LATER)
define_flag("fault_spec", "",
            "Deterministic fault-injection spec (testing.fault grammar), "
            "armed from the environment at import or by "
            "testing.fault.arm_from_flags().")
define_flag("fault_seed", 0,
            "Seed for the fault injector's RNG.")
define_flag("fs_retry_times", 4,
            "Max attempts for a filesystem op that fails with a "
            "transient error. " + _LATER)
define_flag("fs_retry_backoff_s", 0.2,
            "Base exponential-backoff delay between fs retries. "
            + _LATER)
define_flag("fs_retry_deadline_s", 60.0,
            "Wall-clock budget across all retry attempts of one fs op. "
            + _LATER)
define_flag("dataloader_timeout", 120,
            "Seconds a DataLoader iterator waits on worker results. "
            + _LATER)
define_flag("dataloader_batch_retries", 3,
            "Times one batch may be re-enqueued after DataLoader worker "
            "deaths. " + _LATER)
define_flag("dataloader_respawn_backoff_s", 0.2,
            "Base delay before respawning a dead DataLoader worker. "
            + _LATER)
define_flag("dataloader_respawn_backoff_max_s", 5.0,
            "Cap on the per-respawn backoff delay. " + _LATER)
define_flag("dataloader_crashloop_window_s", 30.0,
            "Sliding window for DataLoader worker crash-loop detection. "
            + _LATER)
define_flag("dataloader_crashloop_budget", 6,
            "Worker deaths tolerated inside the crash-loop window. "
            + _LATER)
define_flag("mesh_replace_warn_only", False,
            "Downgrade the error raised when a live mesh would be "
            "replaced to a warning. " + _LATER)
define_flag("checkpoint_keep_max", 2,
            "Snapshots retained per checkpoint dir (the default of "
            "utils.checkpoint.SnapshotStore's keep_max).")
define_flag("inference_pad_policy", "bucket",
            "Predictor.run on a batch size with no compiled variant: "
            "'bucket' or 'none'. " + _LATER)
define_flag("serving_dispatch_retries", 2,
            "InferenceEngine: batch dispatch attempts after a failure. "
            + _LATER)
define_flag("serving_decode_retries", 2,
            "GenerationEngine: decode-step attempts after a failure "
            "before the in-flight sequences are failed (injected faults "
            "fire before the step touches the KV pool, so they are "
            "safely retried).")
define_flag("metrics_dump_path", "",
            "Default JSONL file observability.dump_metrics appends "
            "monitor-metrics snapshots to.")
define_flag("flight_recorder_path", "",
            "Default dump path for the crash flight recorder "
            "(observability.install_flight_recorder; else "
            "./flight_record.json).")
define_flag("perf_sample_every", 16,
            "Performance observatory (observability.enable_perf): time "
            "the device lane by CUDA events and sample device memory on "
            "every Nth step of a build identity or engine; <= 0 keeps "
            "the host lane only.")
define_flag("perf_chip", "",
            "The static/analysis/cost.CHIP_SPECS row the cost model "
            "prices a step against (the Executor's predicted record and "
            "the performance observatory's drift).  Empty = auto: "
            "'h100' on an H100, else 'cpu'.")
define_flag("pallas_interpret", False,
            "Pallas interpret mode off the TPU (the card's kernels have "
            "none: a CPU tensor takes the plain versions).")
define_flag("xla_latency_hiding", False,
            "XLA's latency-hiding scheduler flags, appended to XLA_FLAGS "
            "at import.")
define_flag("anomaly_sentry", False,
            "Fuse the data-plane anomaly sentry into the static "
            "Executor's step: a run with a non-finite gradient, loss or "
            "gradient norm updates nothing (decided on the device).")
define_flag("anomaly_skip_budget", 2,
            "AnomalyPolicy: consecutive flagged steps tolerated.")
define_flag("anomaly_rollback_budget", 1,
            "AnomalyPolicy: snapshot rollbacks attempted.")
define_flag("anomaly_spike_window", 32,
            "AnomalyPolicy rolling window for the loss-spike detector.")
define_flag("anomaly_spike_factor", 10.0,
            "AnomalyPolicy: loss-spike factor over the window's median.")
define_flag("compile_cache_dir", "",
            "The persistent cache of serialized XLA executables.")
define_flag("metrics_dump_max_mb", 0.0,
            "Size-based rotation threshold (MiB) of the metrics dump: at "
            "or above it the file shifts to .1 before the next append; "
            "0 = never rotate.")
define_flag("metrics_dump_keep", 3,
            "Rotated metrics-dump files retained (.1 .. .N).")
define_flag("obs_spool_dir", "",
            "Fleet telemetry spool directory: set in the environment, "
            "the exporter installs at import and spools this process's "
            "metrics and trace there (observability.install_exporter).")
define_flag("obs_role", "",
            "Role label for this process's telemetry spool "
            "(<role>-<pid>; empty = 'proc').")
define_flag("obs_export_interval_s", 5.0,
            "Seconds between telemetry spool flushes (at least 0.05).")
define_flag("pallas_attention_dropout_min_seqlen", 512,
            "The TPU's flash-attention length threshold under dropout "
            "(the card's gate has none).")
