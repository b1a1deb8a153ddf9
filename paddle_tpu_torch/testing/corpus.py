"""A seeded synthetic corpus and the user-style masked-LM dataset over it:
what a hapi user feeds ``Model.fit`` through ``io.DataLoader`` workers.

:func:`write_corpus` writes a WordPiece vocabulary (``[PAD] [UNK] [CLS]
[SEP] [MASK]``, whole words ``w<i>`` and continuation pieces ``##p<j>``)
and documents of whitespace-separated words whose whole-word part follows
a Zipf law, a share of them carrying a continuation piece.
:class:`MaskedLMCorpus` tokenizes document ``i`` with
``text.FastWordPieceTokenizer`` to ``seq`` ids, masks 15 % of the
positions inside the ``[CLS] ... [SEP]`` frame with ``[MASK]`` drawn by
``RandomState(i)``, and returns ``(ids, labels)`` as numpy: the masked
int32 ids and the original ids as int64 labels.  It is module-level and
holds only paths, so DataLoader worker processes unpickle it and build
their own tokenizer.  With ``probe_dir`` set, each process that serves a
sample writes ``torch.cuda.is_initialized()`` into
``probe_dir/item-<pid>.json`` (and :func:`report_worker` into
``worker-<pid>.json`` from ``worker_init_fn``), so a caller can hold
that no worker made a CUDA context."""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..io import Dataset

__all__ = ["SPECIALS", "MASK_SHARE", "write_corpus", "MaskedLMCorpus",
           "report_worker", "worker_reports"]

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
MASK_SHARE = 0.15


def write_corpus(directory: str, n_docs: int, vocab_size: int,
                 words_per_doc=(380, 520), piece_share: float = 0.3,
                 zipf_a: float = 1.1, seed: int = 0):
    """Write ``vocab.txt`` (``vocab_size`` entries) and ``corpus.txt``
    (``n_docs`` lines) under ``directory``; returns their paths."""
    rng = np.random.RandomState(seed)
    n_words = (vocab_size - len(SPECIALS)) * 2 // 3
    n_pieces = vocab_size - len(SPECIALS) - n_words
    vocab = (SPECIALS + [f"w{i}" for i in range(n_words)]
             + [f"##p{j}" for j in range(n_pieces)])
    os.makedirs(directory, exist_ok=True)
    vocab_path = os.path.join(directory, "vocab.txt")
    with open(vocab_path, "w") as f:
        f.write("\n".join(vocab) + "\n")
    p = 1.0 / np.arange(1, n_words + 1) ** zipf_a
    p /= p.sum()
    corpus_path = os.path.join(directory, "corpus.txt")
    with open(corpus_path, "w") as f:
        for _ in range(n_docs):
            n = rng.randint(*words_per_doc)
            words = rng.choice(n_words, n, p=p)
            pieces = rng.randint(0, n_pieces, n)
            glued = rng.rand(n) < piece_share
            f.write(" ".join(f"w{w}p{q}" if g else f"w{w}"
                             for w, q, g in zip(words, pieces, glued))
                    + "\n")
    return vocab_path, corpus_path


def _write_json(path: str, obj) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def report_worker(probe_dir: str, worker_id: int) -> None:
    """A ``worker_init_fn`` (bind ``probe_dir`` with
    ``functools.partial``): records this worker's pid and whether it has
    a CUDA context."""
    import torch
    _write_json(os.path.join(probe_dir, f"worker-{os.getpid()}.json"),
                {"worker": worker_id, "pid": os.getpid(),
                 "cuda_initialized": torch.cuda.is_initialized()})


def worker_reports(probe_dir: str):
    """Every report under ``probe_dir``: (file name, its record)."""
    out = []
    for name in sorted(os.listdir(probe_dir)):
        if name.endswith(".json"):
            with open(os.path.join(probe_dir, name)) as f:
                out.append((name, json.load(f)))
    return out


class MaskedLMCorpus(Dataset):
    """Document ``i`` of ``corpus_path`` as ``(masked ids int32 [seq],
    labels int64 [seq])``; see the module docstring."""

    def __init__(self, vocab_path: str, corpus_path: str, seq: int,
                 probe_dir: Optional[str] = None, use_native: bool = True):
        self.vocab_path = vocab_path
        self.seq = seq
        self.probe_dir = probe_dir
        self.use_native = use_native
        with open(corpus_path) as f:
            self.docs = f.read().splitlines()
        self._tok = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_tok"] = None          # each process builds its own
        return state

    def tokenizer(self):
        if self._tok is None:
            from ..text import FastWordPieceTokenizer
            self._tok = FastWordPieceTokenizer(self.vocab_path,
                                               use_native=self.use_native)
        return self._tok

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        tok = self.tokenizer()
        ids, lens = tok.encode_batch([self.docs[i]], max_len=self.seq)
        ids, n = ids[0], int(lens[0])
        labels = ids.astype(np.int64)
        rs = np.random.RandomState(i)
        masked = ids.copy()
        where = 1 + np.flatnonzero(rs.rand(n - 2) < MASK_SHARE)
        masked[where] = tok.vocab["[MASK]"]
        if self.probe_dir is not None:
            import torch
            _write_json(os.path.join(self.probe_dir,
                                     f"item-{os.getpid()}.json"),
                        {"pid": os.getpid(),
                         "cuda_initialized": torch.cuda.is_initialized()})
        return masked, labels
