"""The record codec, frozen: the bytes the string API reads and writes.

Binary records lead with a little-endian int32 type UID: 42 LweSample
(a[n] i32, b i32, variance f64), 43 LweKey, 169 TGswKey, 200
LweKeySwitchKey, 201 LweBootstrappingKey.  A secret keyset is the text
sections GATEBOOTSPARAMS, LWEPARAMS, TGSWPARAMS, TLWEPARAMS and
LWEKSPARAMS (doubles as C++'s ``std::ostream`` prints them, ``%.6g``), then
records 200, 201, 43 and 169.  Base64 wraps every blob.
"""

from __future__ import annotations

import base64
import struct

import numpy as np

LWE_SAMPLE_UID = 42
LWE_KEY_UID = 43
TGSW_KEY_UID = 169
KEYSWITCH_KEY_UID = 200
BOOTSTRAP_KEY_UID = 201

_I32 = struct.Struct("<i")
_F64 = struct.Struct("<d")


def _section(title: str, props: dict) -> bytes:
    lines = [f"-----BEGIN {title}-----"]
    lines += [f"{k}: {v:.6g}" if isinstance(v, float) else f"{k}: {v}"
              for k, v in props.items()]
    lines.append(f"-----END {title}-----")
    return ("\n".join(lines) + "\n").encode()


def secret_keyset(p, lwe: np.ndarray, ring: np.ndarray, bk: np.ndarray,
                  ks: np.ndarray) -> bytes:
    """A secret keyset blob of parameter set ``p`` (``reference.tfhe.Params``)
    and its keys as int32 arrays; the variances are the sets' alpha_min^2."""
    bk_var = float(np.float32(p.bk_stdev) * np.float32(p.bk_stdev))
    ks_var = float(np.float32(p.ks_stdev) * np.float32(p.ks_stdev))
    n_in, t, _, _ = ks.shape
    out = [_section("GATEBOOTSPARAMS", {"ks_t": p.ks_t, "ks_basebit": p.ks_basebit}),
           _section("LWEPARAMS", {"n": p.n, "alpha_min": p.ks_stdev, "alpha_max": p.max_stdev}),
           _section("TGSWPARAMS", {"l": p.l, "Bgbit": p.Bgbit}),
           _section("TLWEPARAMS", {"N": p.N, "k": p.k, "alpha_min": p.bk_stdev,
                                   "alpha_max": p.max_stdev}),
           _section("LWEKSPARAMS", {"n": n_in, "t": t, "basebit": p.ks_basebit}),
           _I32.pack(KEYSWITCH_KEY_UID), _F64.pack(ks_var),
           np.ascontiguousarray(ks, "<i4").tobytes(),
           _I32.pack(KEYSWITCH_KEY_UID), _F64.pack(ks_var),
           _I32.pack(BOOTSTRAP_KEY_UID), _F64.pack(bk_var),
           np.ascontiguousarray(bk, "<i4").tobytes(),
           _I32.pack(LWE_KEY_UID), np.ascontiguousarray(lwe, "<i4").tobytes(),
           _I32.pack(TGSW_KEY_UID), np.ascontiguousarray(ring, "<i4").tobytes()]
    return b"".join(out)


def pack_samples(a: np.ndarray, b: np.ndarray, var: float) -> bytes:
    """(B, n) and (B,) int32 -> B UID-42 records with variance ``var``."""
    B, n = a.shape
    rec = np.zeros((B, 4 + 4 * n + 4 + 8), np.uint8)
    rec[:, :4] = np.frombuffer(_I32.pack(LWE_SAMPLE_UID), np.uint8)
    rec[:, 4:4 + 4 * n] = np.ascontiguousarray(a, "<i4").view(np.uint8).reshape(B, -1)
    rec[:, 4 + 4 * n:8 + 4 * n] = np.ascontiguousarray(b, "<i4").view(np.uint8).reshape(B, 4)
    rec[:, 8 + 4 * n:] = np.frombuffer(_F64.pack(var), np.uint8)
    return rec.tobytes()


def unpack_samples(data: bytes, B: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """B UID-42 records -> (a (B, n), b (B,)) int32; raises on a short or
    mislabelled stream."""
    size = 4 + 4 * n + 4 + 8
    if len(data) < B * size:
        raise ValueError(f"wanted {B} records of {size} bytes, got {len(data)} bytes")
    rec = np.frombuffer(data, np.uint8, count=B * size).reshape(B, size)
    if (rec[:, :4].copy().view("<i4").ravel() != LWE_SAMPLE_UID).any():
        raise ValueError("a record is not an LweSample (UID 42)")
    a = rec[:, 4:4 + 4 * n].copy().view("<i4").reshape(B, n)
    b = rec[:, 4 + 4 * n:8 + 4 * n].copy().view("<i4").ravel()
    return a, b


def b64encode(data: bytes) -> str:
    return base64.b64encode(data).decode()


def b64decode(s: str) -> bytes:
    return base64.b64decode(s)
