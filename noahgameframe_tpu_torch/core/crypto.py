"""RC4 stream cipher for ciphered config files.

The reference ships an RC4 utility for optionally-encrypted data files
(`NFComm/NFConfigPlugin/myrc4.{h,cpp}` — present but unused by any module
in the snapshot).  This is the standard textbook RC4 (KSA + PRGA) plus the
config convention this framework uses: a ciphered XML file carries the
``NFRC4`` magic prefix so loaders can transparently decrypt when given a
key and pass plaintext files through untouched.

RC4 is obsolete as cryptography; it is kept solely for config obfuscation
parity with the reference — do not use it to protect secrets.

A copy of ``noahgameframe_tpu/core/crypto.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

MAGIC = b"NFRC4\x00"


def rc4(key: bytes, data: bytes) -> bytes:
    """RC4 keystream XOR (encrypt == decrypt)."""
    if not key:
        raise ValueError("rc4 key must be non-empty")
    s = list(range(256))
    j = 0
    for i in range(256):
        j = (j + s[i] + key[i % len(key)]) & 0xFF
        s[i], s[j] = s[j], s[i]
    out = bytearray(len(data))
    i = j = 0
    for n, b in enumerate(data):
        i = (i + 1) & 0xFF
        j = (j + s[i]) & 0xFF
        s[i], s[j] = s[j], s[i]
        out[n] = b ^ s[(s[i] + s[j]) & 0xFF]
    return bytes(out)


def encrypt_config(data: bytes, key: Union[str, bytes]) -> bytes:
    """Plaintext -> NFRC4-prefixed ciphertext (tools-side helper)."""
    if isinstance(key, str):
        key = key.encode()
    return MAGIC + rc4(key, data)


def decrypt_config(data: bytes, key: Union[str, bytes, None]) -> bytes:
    """Ciphertext (or plaintext) -> plaintext.

    Files without the magic prefix pass through unchanged; ciphered files
    require a key."""
    if not data.startswith(MAGIC):
        return data
    if key is None:
        raise ValueError("config file is RC4-ciphered but no key was given")
    if isinstance(key, str):
        key = key.encode()
    return rc4(key, data[len(MAGIC):])


def read_config_bytes(path: Path, key: Union[str, bytes, None] = None) -> bytes:
    """Read a config file, transparently decrypting NFRC4 content."""
    return decrypt_config(Path(path).read_bytes(), key)
