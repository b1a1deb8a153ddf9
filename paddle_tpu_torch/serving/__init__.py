"""Serving: the dynamic-batching inference engine, the model registry,
generative serving over the paged KV cache, the reference paged decoder
and the HTTP front end (``http.serve`` and the
``python -m paddle_tpu_torch.serving.serve`` CLI run one)."""
from .engine import (DeadlineExceeded, EngineClosed,  # noqa: F401
                     InferenceEngine, QueueFull, ServingError)
from .generation import (GenerationEngine, GenerationError,  # noqa: F401
                         GenerationStream)
from .http import Client, ServingServer  # noqa: F401
from .kv_cache import (KVCacheConfig, PagePool, pages_needed,  # noqa: F401
                       write_prompt, write_token)
from .models import PagedDecoderLM, params_from_paddle_tpu  # noqa: F401
from .registry import (ModelEntry, ModelRegistry,  # noqa: F401
                       QuotaExceeded, ReplicaSet, UnknownModel)

__all__ = ["InferenceEngine", "ServingError", "QueueFull",
           "DeadlineExceeded", "EngineClosed", "GenerationEngine",
           "GenerationStream", "GenerationError", "ServingServer", "Client",
           "KVCacheConfig", "PagePool", "pages_needed",
           "write_token", "write_prompt", "PagedDecoderLM",
           "params_from_paddle_tpu", "ModelRegistry", "ModelEntry",
           "UnknownModel", "QuotaExceeded", "ReplicaSet"]
