"""At-rest encryption: ChaCha20-Poly1305 / AES-256-GCM envelopes + key ring.

Parity with the reference's crypto stack (handler/chacha20_poly1305.dart
1,057 LoC pure-Dart, aes_gcm.dart, encoder.dart prefixed formats ToU8_/
ToCh_/ToAe_ with keyId fallbacks :28-60, to_crypto.dart value-level API,
key_manager.dart online key rotation): envelopes carry a format magic +
key id so a key ring can decrypt artifacts written under older keys, which
is what makes online rotation (re-encrypt on next checkpoint) safe.

Fast path uses the `cryptography` package; a pure-Python ChaCha20-Poly1305
(RFC 8439) is included as the no-dependency fallback and format oracle —
the reference is likewise pure-Dart.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import struct

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM, ChaCha20Poly1305

    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover
    _HAVE_CRYPTOGRAPHY = False

# --- pure-Python ChaCha20-Poly1305 (RFC 8439) --------------------------------


def _rotl32(v, c):
    return ((v << c) & 0xFFFFFFFF) | (v >> (32 - c))


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl32(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl32(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl32(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl32(s[b] ^ s[c], 7)


def _chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    st = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *struct.unpack("<8I", key),
        counter,
        *struct.unpack("<3I", nonce),
    ]
    w = list(st)
    for _ in range(10):
        _quarter(w, 0, 4, 8, 12)
        _quarter(w, 1, 5, 9, 13)
        _quarter(w, 2, 6, 10, 14)
        _quarter(w, 3, 7, 11, 15)
        _quarter(w, 0, 5, 10, 15)
        _quarter(w, 1, 6, 11, 12)
        _quarter(w, 2, 7, 8, 13)
        _quarter(w, 3, 4, 9, 14)
    return struct.pack("<16I", *[(a + b) & 0xFFFFFFFF for a, b in zip(w, st)])


def _chacha20_xor(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        block = _chacha20_block(key, counter + i // 64, nonce)
        chunk = data[i : i + 64]
        out[i : i + len(chunk)] = bytes(x ^ y for x, y in zip(chunk, block))
    return bytes(out)


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i : i + 16]
        n = int.from_bytes(chunk + b"\x01", "little")
        acc = ((acc + n) * r) % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


def chacha20poly1305_seal(key: bytes, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    """RFC 8439 AEAD seal: returns ciphertext || 16-byte tag."""
    if _HAVE_CRYPTOGRAPHY:
        return ChaCha20Poly1305(key).encrypt(nonce, plaintext, aad or None)
    otk = _chacha20_block(key, 0, nonce)[:32]
    ct = _chacha20_xor(key, 1, nonce, plaintext)
    mac_data = (
        aad + _pad16(aad) + ct + _pad16(ct)
        + struct.pack("<QQ", len(aad), len(ct))
    )
    return ct + _poly1305(otk, mac_data)


def chacha20poly1305_open(key: bytes, nonce: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
    if _HAVE_CRYPTOGRAPHY:
        return ChaCha20Poly1305(key).decrypt(nonce, sealed, aad or None)
    ct, tag = sealed[:-16], sealed[-16:]
    otk = _chacha20_block(key, 0, nonce)[:32]
    mac_data = (
        aad + _pad16(aad) + ct + _pad16(ct)
        + struct.pack("<QQ", len(aad), len(ct))
    )
    if not _hmac.compare_digest(_poly1305(otk, mac_data), tag):
        raise ValueError("authentication failed")
    return _chacha20_xor(key, 1, nonce, ct)


# --- envelope formats (reference EncoderHandler ToCh_/ToAe_ prefixes) ----------

MAGIC_CHACHA = b"TCh1"
MAGIC_AESGCM = b"TAe1"
NONCE_LEN = 12


# Legacy v1 artifacts used a fixed salt + 10k iterations; new databases
# generate a random per-database salt (persisted in the manifest) and use
# DEFAULT_KDF_ITERS. The legacy values stay as signature defaults only so
# round-1 databases keep decrypting.
LEGACY_KDF_SALT = b"tostore_tpu.v1"
LEGACY_KDF_ITERS = 10_000
DEFAULT_KDF_ITERS = 600_000  # OWASP 2023+ guidance for PBKDF2-SHA256


def derive_key(
    passphrase: str, salt: bytes = LEGACY_KDF_SALT, iters: int = LEGACY_KDF_ITERS
) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", passphrase.encode(), salt, iters, dklen=32)


def device_binding_factor(db_dir: str) -> bytes:
    """Host+path-bound key factor (reference data_store_config.dart:945-961
    path-based device binding): a stable machine identity (/etc/machine-id,
    hostname fallback) mixed with the database's absolute path. Mixing this
    into the KDF salt makes a byte-identical copy of the database
    undecryptable on another host or at another path."""
    import socket

    try:
        with open("/etc/machine-id", "rb") as f:
            mid = f.read().strip()
        if not mid:
            raise OSError
    except OSError:
        mid = socket.gethostname().encode()
    path = os.path.realpath(db_dir).encode()
    return hashlib.sha256(b"tostore_tpu.bind\x00" + mid + b"\x00" + path).digest()


class KeyRing:
    """key_id -> 32-byte key; `current` encrypts, all ids decrypt
    (reference encoder.dart keyId fallbacks + key rotation)."""

    def __init__(
        self,
        keys: dict[int, bytes],
        current: int,
        salt: bytes = LEGACY_KDF_SALT,
        iters: int = LEGACY_KDF_ITERS,
    ):
        if current not in keys:
            raise ValueError("current key id not in ring")
        self.keys = dict(keys)
        self.current = current
        self.salt = salt
        self.iters = iters

    @staticmethod
    def from_passphrase(
        passphrase: str,
        key_id: int = 1,
        salt: bytes = LEGACY_KDF_SALT,
        iters: int = LEGACY_KDF_ITERS,
    ) -> "KeyRing":
        return KeyRing({key_id: derive_key(passphrase, salt, iters)}, key_id, salt, iters)

    def rotate(self, new_passphrase: str) -> int:
        """Add a new key; returns its id. Old keys stay for decryption until
        artifacts are re-encrypted (next checkpoint) and `retire` is called."""
        new_id = max(self.keys) + 1
        self.keys[new_id] = derive_key(new_passphrase, self.salt, self.iters)
        self.current = new_id
        return new_id

    def retire(self, key_id: int):
        if key_id == self.current:
            raise ValueError("cannot retire the current key")
        self.keys.pop(key_id, None)


class Envelope:
    """Encrypt/decrypt byte blobs with a KeyRing.

    Layout: magic(4) | key_id u16 LE | nonce(12) | ciphertext+tag.
    """

    def __init__(self, ring: KeyRing, algorithm: str = "chacha20-poly1305"):
        self.ring = ring
        if algorithm not in ("chacha20-poly1305", "aes-gcm"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if algorithm == "aes-gcm" and not _HAVE_CRYPTOGRAPHY:
            raise ValueError("aes-gcm requires the cryptography package")
        self.algorithm = algorithm

    def seal(self, plaintext: bytes, aad: bytes = b"") -> bytes:
        nonce = os.urandom(NONCE_LEN)
        key = self.ring.keys[self.ring.current]
        if self.algorithm == "aes-gcm":
            magic = MAGIC_AESGCM
            ct = AESGCM(key).encrypt(nonce, plaintext, aad or None)
        else:
            magic = MAGIC_CHACHA
            ct = chacha20poly1305_seal(key, nonce, plaintext, aad)
        return magic + struct.pack("<H", self.ring.current) + nonce + ct

    def open(self, blob: bytes, aad: bytes = b"") -> bytes:
        magic, blob2 = blob[:4], blob[4:]
        (key_id,) = struct.unpack_from("<H", blob2)
        nonce = blob2[2 : 2 + NONCE_LEN]
        ct = blob2[2 + NONCE_LEN :]
        if magic not in (MAGIC_AESGCM, MAGIC_CHACHA):
            raise ValueError(f"unknown envelope magic {magic!r}")

        def _open(key):
            if magic == MAGIC_AESGCM:
                return AESGCM(key).decrypt(nonce, ct, aad or None)
            return chacha20poly1305_open(key, nonce, ct, aad)

        key = self.ring.keys.get(key_id)
        if key is not None:
            return _open(key)
        # key-id fallback (reference encoder.dart:28-60): after a rotation
        # the artifact may carry an id the fresh ring doesn't know — try the
        # ring's keys; the AEAD tag authenticates the right one
        last_err = None
        for k in self.ring.keys.values():
            try:
                return _open(k)
            except Exception as e:  # InvalidTag / ValueError
                last_err = e
        raise ValueError(f"no key decrypts envelope id {key_id}") from last_err

    @staticmethod
    def is_sealed(blob: bytes) -> bool:
        return blob[:4] in (MAGIC_CHACHA, MAGIC_AESGCM)


class ToCrypto:
    """Standalone value-level crypto API (reference to_crypto.dart)."""

    def __init__(self, passphrase: str, algorithm: str = "chacha20-poly1305"):
        self._env = Envelope(KeyRing.from_passphrase(passphrase), algorithm)

    def encrypt_bytes(self, data: bytes) -> bytes:
        return self._env.seal(data)

    def decrypt_bytes(self, blob: bytes) -> bytes:
        return self._env.open(blob)

    def encrypt_text(self, text: str) -> bytes:
        return self._env.seal(text.encode())

    def decrypt_text(self, blob: bytes) -> str:
        return self._env.open(blob).decode()

    @staticmethod
    def sha256(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()
