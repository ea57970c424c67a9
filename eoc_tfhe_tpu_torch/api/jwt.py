"""JWT validation gate: the reference wrapper's structural check, plus RS256.

Port (a copy) of ``eoc_tfhe_tpu/api/jwt.py``.  :func:`validate_jwt` is the
reference wrapper's ``validateJWT``: structural checks only, with its quirk
that only the FIRST dot splits, so a three-part token's signature is lumped
into the payload.  :func:`verify_rs256` verifies an RSASSA-PKCS1-v1_5 /
SHA-256 signature against a JWKS document in pure Python.
"""

from __future__ import annotations

import base64
import hashlib
import json

_B64URL = set("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_=")

#: DER DigestInfo prefix for SHA-256 (RFC 8017 §9.2 note 1).
_SHA256_DIGESTINFO = bytes.fromhex(
    "3031300d060960864801650304020105000420")


def _b64url_decode(s: str) -> bytes:
    s = s + "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s)


def _b64url_uint(s: str) -> int:
    return int.from_bytes(_b64url_decode(s), "big")


def verify_rs256(token: str, jwks_json: str) -> bool:
    """Verify a three-part JWT's RS256 signature against a JWKS document.

    jwks_json: the JWKS as JSON text — ``{"keys": [{"kty": "RSA", "n": ...,
    "e": ..., "kid": ...}, ...]}``. Key selection: header ``kid`` when
    present, else every RSA key is tried.
    """
    try:
        parts = token.split(".")
        if len(parts) != 3:
            return False
        header = json.loads(_b64url_decode(parts[0]))
        if header.get("alg") != "RS256":
            return False
        signature = _b64url_decode(parts[2])
        signing_input = (parts[0] + "." + parts[1]).encode("ascii")
        digest = hashlib.sha256(signing_input).digest()

        keys = json.loads(jwks_json).get("keys", [])
        kid = header.get("kid")
        candidates = [k for k in keys if k.get("kty") == "RSA"
                      and (kid is None or k.get("kid") == kid)]
        for key in candidates:
            n = _b64url_uint(key["n"])
            e = _b64url_uint(key["e"])
            k = (n.bit_length() + 7) // 8
            if len(signature) != k:
                continue
            em = pow(int.from_bytes(signature, "big"), e, n).to_bytes(k, "big")
            # EMSA-PKCS1-v1_5: 0x00 0x01 PS(0xff..) 0x00 DigestInfo || H
            expect = (b"\x00\x01" + b"\xff" * (k - 3 - len(_SHA256_DIGESTINFO)
                                               - len(digest))
                      + b"\x00" + _SHA256_DIGESTINFO + digest)
            if em == expect:
                return True
        return False
    except Exception:
        return False


def validate_jwt(token: str, jwks_base64: str = "") -> bool:
    """Structural JWT validation (reference parity)."""
    if not token:
        return False
    dot = token.find(".")
    if dot in (-1, 0, len(token) - 1):
        return False
    header, payload = token[:dot], token[dot + 1:]

    def is_b64url(s: str) -> bool:
        return bool(s) and all(c in _B64URL for c in s)

    # Reference quirk preserved: only the FIRST dot splits, so for a
    # standard three-part JWT the "payload" is payload.signature, whose
    # embedded '.' fails the character check. The reference tests never
    # assert on the result (tests/tfhe.test.js:56-76).
    return is_b64url(header) and is_b64url(payload)
