from . import (attention, chunk_matmul, collective_matmul,  # noqa: F401
               creation, cuda, flash_attention, fused_adam, fused_epilogue,
               manipulation)
from .attention import (paged_attention_reference,  # noqa: F401
                        paged_attention_select, paged_attention_supported)
