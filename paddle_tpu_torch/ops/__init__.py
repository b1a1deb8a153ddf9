from . import (attention, creation, cuda, flash_attention,  # noqa: F401
               fused_adam, fused_epilogue)
from .attention import (paged_attention_reference,  # noqa: F401
                        paged_attention_select)
