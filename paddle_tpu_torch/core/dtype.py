"""dtype names (``paddle_tpu.core.dtype``): paddle's names map onto
torch dtypes, and ``paddle.float32`` and its siblings *are* the torch
dtypes, so ``x.dtype == paddle.float32`` holds as in paddle_tpu.

The default float dtype is float32 (:func:`set_default_dtype`).  Unlike
paddle_tpu without x64, integers stay int64: ``to_tensor([1, 2])`` is
int64, as in Paddle and torch."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "dtype_name", "get_default_dtype",
           "set_default_dtype", "bfloat16", "bool_",
           "complex64", "complex128", "float16", "float32", "float64", "int8",
           "int16", "int32", "int64", "uint8"]

bfloat16 = torch.bfloat16
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
           "complex64": torch.complex64, "complex128": torch.complex128,
           "float": torch.float32, "double": torch.float64,
           "half": torch.float16, "int": torch.int32, "long": torch.int64}

_default = torch.float32


def convert_dtype(dtype) -> torch.dtype:
    """A paddle dtype name, a numpy dtype or a torch dtype -> torch."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, np.dtype) or (isinstance(dtype, type)
                                       and issubclass(dtype, np.generic)):
        dtype = np.dtype(dtype).name
    name = str(dtype).replace("paddle.", "").replace("torch.", "")
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPES[name]


def dtype_name(dtype) -> str:
    return str(convert_dtype(dtype)).replace("torch.", "")


def set_default_dtype(d):
    """paddle.set_default_dtype: the float dtype of creation ops and of
    ``to_tensor`` on Python floats."""
    global _default
    d = convert_dtype(d)
    if not d.is_floating_point:
        raise TypeError(f"set_default_dtype: {d} is not a float dtype")
    _default = d


def get_default_dtype() -> torch.dtype:
    return _default
