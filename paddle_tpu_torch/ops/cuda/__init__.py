"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use."""
from . import chunk_matmul, support  # noqa: F401
from .flash_attention import (flash_attention_bwd_dkv,  # noqa: F401
                              flash_attention_bwd_dq, flash_attention_fwd)
from .fused_adam import AdamTable  # noqa: F401
from .fused_epilogue import (fused_epilogue_bwd,  # noqa: F401
                             fused_epilogue_fwd)
from .paged_attention import paged_attention_decode  # noqa: F401
