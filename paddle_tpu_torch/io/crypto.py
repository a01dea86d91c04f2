"""Model-artifact encryption (the port's copy of
``paddle_tpu/io/crypto.py``; ref: paddle/fluid/framework/io/crypto/ —
``CipherFactory``/``AESCipher`` encrypting saved program+params so
deployed model files are opaque at rest; Python surface
fluid/io.py save/load ``use_cipher``).

Constraint: no third-party crypto dependency is baked into
the image, so instead of AES this uses an HMAC-SHA256 construction
from the stdlib only — a textbook PRF-based scheme, not homegrown
primitives:

- keys: enc/mac subkeys derived from the user key by HMAC (HKDF-style
  domain separation).
- confidentiality: a SHAKE-256 XOF keystream — keystream =
  SHAKE256(enc_key || nonce).digest(len(plaintext)), XORed in. A
  keyed XOF is the standard sponge-based stream cipher construction
  (SHAKE modeled as a random oracle; disjoint keystreams come from the
  fresh random 16-byte nonce per encryption), and hashlib computes the
  whole keystream in C in one call.
- integrity: encrypt-then-MAC — tag = HMAC(mac_key, header || nonce
  || ciphertext), verified with ``hmac.compare_digest`` before any
  decryption output.

Throughput is SHAKE/XOR-bound (hundreds of MB/s, keystream in one C
call, XOR in numpy) — artifact files are written once at export;
load-time decryption of even multi-GB params is seconds, off the
serving hot path.
"""

from __future__ import annotations

import hmac
import os
from hashlib import sha256, shake_256

_MAGIC = b"PTENC1\x00\x00"


def _subkeys(key: bytes):
    if not isinstance(key, (bytes, bytearray)) or len(key) < 16:
        raise ValueError("encryption key must be bytes of length >= 16")
    enc = hmac.new(bytes(key), b"paddle_tpu.enc", sha256).digest()
    mac = hmac.new(bytes(key), b"paddle_tpu.mac", sha256).digest()
    return enc, mac


def _keystream_xor(enc_key: bytes, nonce: bytes, data: bytes) -> bytes:
    import numpy as np
    ks = shake_256(enc_key + nonce).digest(len(data))
    a = np.frombuffer(data, np.uint8)
    b = np.frombuffer(ks, np.uint8)
    return np.bitwise_xor(a, b).tobytes()


def encrypt_bytes(data: bytes, key: bytes) -> bytes:
    """magic || nonce(16) || tag(32) || ciphertext."""
    enc_key, mac_key = _subkeys(key)
    nonce = os.urandom(16)
    ct = _keystream_xor(enc_key, nonce, bytes(data))
    tag = hmac.new(mac_key, _MAGIC + nonce + ct, sha256).digest()
    return _MAGIC + nonce + tag + ct


def decrypt_bytes(blob: bytes, key: bytes) -> bytes:
    if blob[:8] != _MAGIC:
        raise ValueError("not a paddle_tpu-encrypted blob")
    enc_key, mac_key = _subkeys(key)
    nonce, tag, ct = blob[8:24], blob[24:56], blob[56:]
    want = hmac.new(mac_key, _MAGIC + nonce + ct, sha256).digest()
    if not hmac.compare_digest(tag, want):
        raise ValueError(
            "artifact authentication failed: wrong key or tampered "
            "file")
    return _keystream_xor(enc_key, nonce, ct)


def is_encrypted(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(8) == _MAGIC
    except OSError:
        return False


def encrypt_file(path: str, key: bytes) -> None:
    with open(path, "rb") as f:
        data = f.read()
    tmp = path + ".enc.tmp"
    with open(tmp, "wb") as f:
        f.write(encrypt_bytes(data, key))
    os.replace(tmp, path)


def decrypt_file_bytes(path: str, key: bytes) -> bytes:
    with open(path, "rb") as f:
        return decrypt_bytes(f.read(), key)
