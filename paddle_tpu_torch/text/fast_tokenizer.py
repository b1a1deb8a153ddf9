"""FastWordPieceTokenizer — a ctypes binding to the native C++ WordPiece
tokenizer (the counterpart of ``paddle_tpu/text/fast_tokenizer.py``).

The library is built at first use with the system ``g++`` from this
package's copy of the source (``csrc/fast_tokenizer.cpp``) into
``build/paddle_tpu_torch_text/`` at the repository root, named by the
digest of its source and command, through the atomic compile-and-rename
of ``utils.native_build``: several DataLoader workers may load it at
once.  Where no compiler is available the pure-Python tokenizer
(``_py_encode``, also the tests' oracle) is used with a warning;
:attr:`FastWordPieceTokenizer.is_native` says which one runs.  Ids come
out as int32, as in paddle_tpu."""
from __future__ import annotations

import ctypes
import hashlib
import os
import threading
import warnings
from typing import Dict, List, Sequence, Union

import numpy as np

from ..utils.native_build import build_shared_lib

__all__ = ["FastWordPieceTokenizer"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "paddle_tpu_torch_text")
_CMD = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_LOCK = threading.Lock()
_LIB = None
_LIB_TRIED = False


def _library_path(src: str) -> str:
    h = hashlib.sha256(" ".join(_CMD).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libfast_tokenizer.{h.hexdigest()[:16]}.so")


def _load_lib():
    """Build (once per source) and load the native tokenizer; None, with
    a warning, when that fails."""
    global _LIB, _LIB_TRIED
    with _LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        src = os.path.join(_CSRC, "fast_tokenizer.cpp")
        try:
            so = _library_path(src)
            if not os.path.exists(so):
                build_shared_lib(_CMD, [src], so,
                                 what="native tokenizer build")
            try:
                lib = ctypes.CDLL(so)
            except OSError:
                # a library built by another toolchain: build it here
                build_shared_lib(_CMD, [src], so,
                                 what="native tokenizer build")
                lib = ctypes.CDLL(so)
        except (OSError, RuntimeError) as e:
            warnings.warn(f"native tokenizer unavailable "
                          f"({type(e).__name__}); using the Python "
                          f"fallback")
            return None
        lib.ft_new.restype = ctypes.c_void_p
        lib.ft_new.argtypes = [ctypes.c_char_p] + [ctypes.c_int32] * 5
        lib.ft_free.argtypes = [ctypes.c_void_p]
        lib.ft_vocab_size.restype = ctypes.c_int32
        lib.ft_vocab_size.argtypes = [ctypes.c_void_p]
        lib.ft_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        _LIB = lib
        return _LIB


def _is_punct(c: str) -> bool:
    o = ord(c)
    return (33 <= o <= 47) or (58 <= o <= 64) or (91 <= o <= 96) or \
        (123 <= o <= 126)


class FastWordPieceTokenizer:
    """BERT-style basic + WordPiece tokenization to padded id matrices.

    ``vocab``: dict token->id, a list of tokens (id = index), or a path
    to a newline-separated vocab file."""

    def __init__(self, vocab: Union[Dict[str, int], Sequence[str], str],
                 unk_token="[UNK]", cls_token="[CLS]", sep_token="[SEP]",
                 pad_token="[PAD]", lowercase: bool = True,
                 use_native: bool = True):
        if isinstance(vocab, str):
            with open(vocab) as f:
                tokens = [ln.rstrip("\n") for ln in f]
        elif isinstance(vocab, dict):
            tokens = [None] * len(vocab)
            for t, i in vocab.items():
                tokens[i] = t
            assert all(t is not None for t in tokens), \
                "vocab ids must be dense 0..n-1"
        else:
            tokens = list(vocab)
        self._tokens = tokens
        self.vocab = {t: i for i, t in enumerate(tokens)}
        self.unk_id = self.vocab.get(unk_token, 0)
        self.cls_id = self.vocab.get(cls_token, 0)
        self.sep_id = self.vocab.get(sep_token, 0)
        self.pad_id = self.vocab.get(pad_token, 0)
        self.lowercase = lowercase
        self._handle = None
        self._lib = _load_lib() if use_native else None
        if self._lib is not None:
            blob = "\n".join(tokens).encode("utf-8")
            self._handle = self._lib.ft_new(
                blob, self.unk_id, self.cls_id, self.sep_id, self.pad_id,
                1 if lowercase else 0)

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def __len__(self):
        return len(self._tokens)

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and h:
            lib.ft_free(h)

    # -- encoding ----------------------------------------------------------
    def encode_batch(self, texts: Sequence[str], max_len: int = 128,
                     n_threads: int = 0):
        """texts -> (ids [B, max_len] int32, lens [B] int32), with
        [CLS]...[SEP] framing and [PAD] fill."""
        if max_len < 2:
            # [CLS] + [SEP] framing needs >= 2 slots; smaller values would
            # drive a negative resize through the C extension
            raise ValueError(
                f"encode_batch: max_len must be >= 2, got {max_len}")
        n = len(texts)
        ids = np.empty((n, max_len), np.int32)
        lens = np.empty((n,), np.int32)
        if self._handle is not None:
            buf = [t.encode("utf-8") for t in texts]
            arr = (ctypes.c_char_p * n)(*buf)
            self._lib.ft_encode_batch(
                self._handle, arr, n, max_len, n_threads,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            return ids, lens
        for i, t in enumerate(texts):
            row = self._py_encode(t, max_len)
            lens[i] = len(row)
            ids[i] = row + [self.pad_id] * (max_len - len(row))
        return ids, lens

    def __call__(self, texts, max_len: int = 128):
        if isinstance(texts, str):
            texts = [texts]
        return self.encode_batch(texts, max_len)[0]

    # -- pure-Python oracle / fallback -------------------------------------
    # NOTE: semantics are byte-level ASCII (space = " \t\n\r", lowercase =
    # A-Z only, multi-byte UTF-8 passes through as word bytes) — the same
    # spec the C++ kernel implements, so native and fallback paths are
    # bit-identical on any input.
    def _basic(self, text: str) -> List[str]:
        out, cur = [], []
        for c in text:
            if c in " \t\n\r":
                if cur:
                    out.append("".join(cur))
                    cur = []
            elif _is_punct(c):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(c)
            else:
                if self.lowercase and "A" <= c <= "Z":
                    c = c.lower()
                cur.append(c)
        if cur:
            out.append("".join(cur))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk_id]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def _py_encode(self, text: str, max_len: int) -> List[int]:
        ids = [self.cls_id]
        for w in self._basic(text):
            if len(ids) >= max_len - 1:
                break
            ids += self._wordpiece(w)
        ids = ids[:max_len - 1]
        ids.append(self.sep_id)
        return ids
