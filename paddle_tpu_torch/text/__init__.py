"""text (``paddle_tpu.text``): the reference's seven text datasets
(:mod:`.datasets`, local archives only) and the native WordPiece
tokenizer (:mod:`.fast_tokenizer`)."""
from __future__ import annotations

from . import datasets  # noqa: F401
from .datasets import (Conll05st, Imdb, Imikolov, Movielens,  # noqa: F401
                       UCIHousing, WMT14, WMT16)
from .fast_tokenizer import FastWordPieceTokenizer  # noqa: F401
