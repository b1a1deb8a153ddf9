"""Encryption of saved artifacts (the counterpart of
``paddle_tpu/utils/crypto.py``): AES-256-GCM over the serialised bytes,
keyed by the SHA-256 of a user's key or key file, in paddle_tpu's layout
(the magic ``PDTPUENC``, a 12-byte nonce, the ciphertext and its tag), so
a file encrypted by either package decrypts in the other.

``cryptography`` is imported inside :func:`encrypt` and :func:`decrypt`
only: a machine without it runs everything but encrypted saves."""
from __future__ import annotations

import hashlib
import os

__all__ = ["generate_key_file", "encrypt", "decrypt", "is_encrypted"]

_MAGIC = b"PDTPUENC"


def _derive(key) -> bytes:
    if isinstance(key, str):
        key = key.encode("utf-8")
    return hashlib.sha256(key).digest()


def generate_key_file(path: str) -> bytes:
    """Write a random 32-byte key to ``path`` and return it."""
    key = os.urandom(32)
    with open(path, "wb") as f:
        f.write(key)
    return key


def encrypt(data: bytes, key) -> bytes:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    nonce = os.urandom(12)
    return _MAGIC + nonce + AESGCM(_derive(key)).encrypt(nonce, data,
                                                         _MAGIC)


def is_encrypted(head: bytes) -> bool:
    return head.startswith(_MAGIC)


def decrypt(blob: bytes, key) -> bytes:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    if not blob.startswith(_MAGIC):
        raise ValueError("not an encrypted paddle_tpu artifact")
    nonce, ct = blob[8:20], blob[20:]
    try:
        return AESGCM(_derive(key)).decrypt(nonce, ct, _MAGIC)
    except Exception as e:
        raise ValueError(
            "decryption failed — wrong key or corrupted artifact") from e
