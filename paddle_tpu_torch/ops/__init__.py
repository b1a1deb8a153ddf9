from . import attention, cuda, flash_attention  # noqa: F401
from .attention import (paged_attention_reference,  # noqa: F401
                        paged_attention_select)
