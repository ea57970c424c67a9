"""tfhe_io-compatible serialization codec.

Port of ``eoc_tfhe_tpu/io/tfhe_io.py``, whose docstring records how the
format was pinned to the reference binary.  The bytes are the reference's:

  * text-mode property sections ``-----BEGIN <TITLE>-----`` / ``-----END
    <TITLE>-----`` with ``key: value`` lines, doubles printed as C++'s
    ``std::ostream`` does (``%.6g``);
  * binary records led by a little-endian int32 type UID: 42 LweSample
    (a[n] i32, b i32, variance f64), 43 LweKey, 169 TGswKey, 200
    LweKeySwitchKey, 201 LweBootstrappingKey, and the framework's 242 seeded
    LweSample (seed 4 u32, b i32, variance f64);
  * keysets in the order GATEBOOTSPARAMS, LWEPARAMS, TLWEPARAMS, TGSWPARAMS,
    LWEKSPARAMS + 200, 201, 43, 169;
  * base64 around every blob, decoded the reference's lenient way.

Records are packed with numpy (the reference's native codec gives the same
bytes).  Keysets cross between the port's tensors and numpy at
:func:`export_secret_keyset` / :func:`import_secret_keyset` and the cloud
pair; imports land on the card unless the caller names a device.
"""

from __future__ import annotations

import base64
import io as _io
import struct

import numpy as np
import torch

from ..core.params import (GateBootstrappingParams, KeySwitchParams, LweParams,
                           TGswParams, TLweParams)

LWE_SAMPLE_UID = 42
LWE_KEY_UID = 43
TGSW_KEY_UID = 169
KEYSWITCH_KEY_UID = 200
BOOTSTRAP_KEY_UID = 201
# Bulk TLweSample array records of the reference's native key format (not
# part of the reference keyset format; the values collide with 169/200, but
# the record types never share a stream).
TLWE_SAMPLE_UID = 169
TLWE_KEY_UID = 200

#: Framework-extension UID for seeded (mask-compressed) LWE samples, outside
#: the reference's UID table so the two record kinds cannot be confused.
SEEDED_LWE_SAMPLE_UID = 242

#: uid i32 + 128-bit seed 4*u32 + b i32 + var f64 = 32 bytes per sample.
SEEDED_LWE_SAMPLE_BYTES = 4 + 16 + 4 + 8

_I32 = struct.Struct("<i")
_F64 = struct.Struct("<d")


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a host numpy array (waits for the device)."""
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Text-mode property sections.
# ---------------------------------------------------------------------------

def format_double_cpp(v: float) -> str:
    """A double as ``std::ostream <<`` prints it by default (``%.6g``)."""
    return f"{float(v):.6g}"


def write_section(f, title: str, props: dict) -> None:
    f.write(f"-----BEGIN {title}-----\n".encode())
    for k, v in props.items():
        if isinstance(v, float):
            v = format_double_cpp(v)
        f.write(f"{k}: {v}\n".encode())
    f.write(f"-----END {title}-----\n".encode())


def read_section(f, expect_title: str | None = None) -> tuple[str, dict]:
    line = f.readline().decode().rstrip("\n")
    if not (line.startswith("-----BEGIN ") and line.endswith("-----")):
        raise ValueError(f"bad section header: {line!r}")
    title = line[len("-----BEGIN "):-len("-----")]
    if expect_title is not None and title != expect_title:
        raise ValueError(f"expected section {expect_title}, got {title}")
    props: dict = {}
    while True:
        raw = f.readline()
        if not raw:
            raise ValueError(f"truncated stream inside section {title}")
        line = raw.decode().rstrip("\n")
        if line == f"-----END {title}-----":
            return title, props
        k, _, v = line.partition(": ")
        props[k] = v


def _read_exact(f, nbytes: int) -> bytes:
    """``f.read(nbytes)`` that raises on a short read (a truncated blob)."""
    data = f.read(nbytes)
    if len(data) != nbytes:
        raise ValueError(f"truncated stream: wanted {nbytes} bytes, got {len(data)}")
    return data


# ---------------------------------------------------------------------------
# Parameter sections.
# ---------------------------------------------------------------------------

def write_lwe_params(f, p: LweParams) -> None:
    write_section(f, "LWEPARAMS", {"n": p.n, "alpha_min": p.alpha_min, "alpha_max": p.alpha_max})


def read_lwe_params(f) -> LweParams:
    _, pr = read_section(f, "LWEPARAMS")
    return LweParams(n=int(pr["n"]), alpha_min=float(pr["alpha_min"]),
                     alpha_max=float(pr["alpha_max"]))


def write_tlwe_params(f, p: TLweParams) -> None:
    write_section(f, "TLWEPARAMS",
                  {"N": p.N, "k": p.k, "alpha_min": p.alpha_min, "alpha_max": p.alpha_max})


def read_tlwe_params(f) -> TLweParams:
    _, pr = read_section(f, "TLWEPARAMS")
    return TLweParams(N=int(pr["N"]), k=int(pr["k"]), alpha_min=float(pr["alpha_min"]),
                      alpha_max=float(pr["alpha_max"]))


def write_tgsw_params(f, p: TGswParams) -> None:
    write_section(f, "TGSWPARAMS", {"l": p.l, "Bgbit": p.Bgbit})
    write_tlwe_params(f, p.tlwe_params)


def read_tgsw_params(f) -> TGswParams:
    _, pr = read_section(f, "TGSWPARAMS")
    tl = read_tlwe_params(f)
    return TGswParams(l=int(pr["l"]), Bgbit=int(pr["Bgbit"]), tlwe_params=tl)


def write_gate_params(f, p: GateBootstrappingParams) -> None:
    write_section(f, "GATEBOOTSPARAMS", {"ks_t": p.ks.t, "ks_basebit": p.ks.basebit})
    write_lwe_params(f, p.in_out_params)
    write_tgsw_params(f, p.tgsw_params)


def read_gate_params(f) -> GateBootstrappingParams:
    _, pr = read_section(f, "GATEBOOTSPARAMS")
    in_out = read_lwe_params(f)
    tgsw = read_tgsw_params(f)
    return GateBootstrappingParams(
        ks=KeySwitchParams(t=int(pr["ks_t"]), basebit=int(pr["ks_basebit"])),
        in_out_params=in_out, tgsw_params=tgsw)


# ---------------------------------------------------------------------------
# Binary records: UID, then the payload.
# ---------------------------------------------------------------------------

def write_lwe_sample(f, a: np.ndarray, b: int, variance: float) -> None:
    """``export_lweSample_toStream``: UID 42, a[n] int32 LE, b int32, variance f64."""
    f.write(_I32.pack(LWE_SAMPLE_UID))
    f.write(np.asarray(a, "<i4").tobytes())
    f.write(_I32.pack(int(np.int32(b))))
    f.write(_F64.pack(float(variance)))


def read_lwe_sample(f, n: int) -> tuple[np.ndarray, int, float]:
    (uid,) = _I32.unpack(_read_exact(f, 4))
    if uid != LWE_SAMPLE_UID:
        raise ValueError(f"bad LweSample UID {uid}")
    a = np.frombuffer(_read_exact(f, 4 * n), "<i4").copy()
    (b,) = _I32.unpack(_read_exact(f, 4))
    (var,) = _F64.unpack(_read_exact(f, 8))
    return a, b, var


def lwe_sample_num_bytes(n: int) -> int:
    return 4 + 4 * n + 4 + 8


def _write_record(f, uid: int, values: np.ndarray) -> None:
    f.write(_I32.pack(uid))
    f.write(np.asarray(values, "<i4").tobytes())


def _read_record(f, uid: int, count: int, what: str) -> np.ndarray:
    (got,) = _I32.unpack(_read_exact(f, 4))
    if got != uid:
        raise ValueError(f"bad {what} UID {got}")
    return np.frombuffer(_read_exact(f, 4 * count), "<i4").copy()


def write_lwe_key(f, key_coefs: np.ndarray) -> None:
    _write_record(f, LWE_KEY_UID, key_coefs)


def read_lwe_key(f, n: int) -> np.ndarray:
    return _read_record(f, LWE_KEY_UID, n, "LweKey")


def write_tlwe_sample(f, polys: np.ndarray, variance: float) -> None:
    """(k+1, N) torus polys + variance."""
    _write_record(f, TLWE_SAMPLE_UID, polys)
    f.write(_F64.pack(float(variance)))


def read_tlwe_sample(f, k: int, N: int) -> tuple[np.ndarray, float]:
    polys = _read_record(f, TLWE_SAMPLE_UID, (k + 1) * N, "TLweSample").reshape(k + 1, N)
    (var,) = _F64.unpack(_read_exact(f, 8))
    return polys, var


def write_tlwe_key(f, key: np.ndarray) -> None:
    _write_record(f, TLWE_KEY_UID, key)


def read_tlwe_key(f, k: int, N: int) -> np.ndarray:
    return _read_record(f, TLWE_KEY_UID, k * N, "TLweKey").reshape(k, N)


def write_tgsw_key(f, key: np.ndarray) -> None:
    _write_record(f, TGSW_KEY_UID, key)


def read_tgsw_key(f, k: int, N: int) -> np.ndarray:
    return _read_record(f, TGSW_KEY_UID, k * N, "TGswKey").reshape(k, N)


# ---------------------------------------------------------------------------
# Bulk record arrays, packed in one vectorized pass.
# ---------------------------------------------------------------------------

def _pack(uid: int, fields: list[tuple[np.ndarray, str]]) -> bytes:
    """B records: the UID, then each (B, ...) field in its little-endian type."""
    B = fields[0][0].shape[0]
    cols = [np.broadcast_to(np.frombuffer(_I32.pack(uid), np.uint8), (B, 4))]
    cols += [np.ascontiguousarray(x, dt).view(np.uint8).reshape(B, -1) for x, dt in fields]
    return np.concatenate(cols, axis=1).tobytes()


def _unpack(data: bytes, B: int, uid: int, widths: list[tuple[int, str]], what: str):
    """Inverse of :func:`_pack` -> one (B, width) array per field."""
    size = 4 + sum(4 * w if dt != "<f8" else 8 * w for w, dt in widths)
    rec = np.frombuffer(data, np.uint8)[: B * size]
    if rec.size != B * size:
        raise ValueError(f"truncated stream: wanted {B} {what} records of {size} bytes")
    rec = rec.reshape(B, size)
    uids = rec[:, :4].copy().view("<i4").ravel()
    if (uids != uid).any():
        raise ValueError(f"bad {what} UID at record {int(np.argmax(uids != uid))}")
    out, at = [], 4
    for w, dt in widths:
        nb = w * (8 if dt == "<f8" else 4)
        out.append(rec[:, at:at + nb].copy().view(dt).reshape(B, w))
        at += nb
    return out


def pack_lwe_samples(a: np.ndarray, b: np.ndarray, var: np.ndarray) -> bytes:
    """(B, n), (B,), (B,) -> B concatenated UID-42 records."""
    B = a.shape[0]
    return _pack(LWE_SAMPLE_UID, [(a, "<i4"), (np.reshape(b, (B, 1)), "<i4"),
                                  (np.reshape(var, (B, 1)), "<f8")])


def unpack_lwe_samples(data: bytes, B: int, n: int):
    """Inverse of :func:`pack_lwe_samples` -> (a (B,n), b (B,), var (B,))."""
    a, b, var = _unpack(data, B, LWE_SAMPLE_UID, [(n, "<i4"), (1, "<i4"), (1, "<f8")],
                        "LweSample")
    return a, b.ravel(), var.ravel()


def pack_seeded_lwe_samples(seed: np.ndarray, b: np.ndarray, var: np.ndarray) -> bytes:
    """(B, 4) uint32, (B,), (B,) -> B concatenated UID-242 records."""
    B = seed.shape[0]
    if seed.shape != (B, 4):
        raise ValueError(f"seed must be (B, 4), got {seed.shape}")
    return _pack(SEEDED_LWE_SAMPLE_UID, [(seed.astype(np.uint32), "<u4"),
                                         (np.reshape(b, (B, 1)), "<i4"),
                                         (np.reshape(var, (B, 1)), "<f8")])


def unpack_seeded_lwe_samples(data: bytes, B: int):
    """Inverse of :func:`pack_seeded_lwe_samples` -> (seed (B,4) uint32,
    b (B,), var (B,))."""
    seed, b, var = _unpack(data, B, SEEDED_LWE_SAMPLE_UID,
                           [(4, "<u4"), (1, "<i4"), (1, "<f8")], "seeded-LweSample")
    return seed, b.ravel(), var.ravel()


def pack_tlwe_samples(polys: np.ndarray, var: np.ndarray) -> bytes:
    """(B, k+1, N), (B,) -> B concatenated UID-169 records."""
    B = polys.shape[0]
    return _pack(TLWE_SAMPLE_UID, [(np.reshape(polys, (B, -1)), "<i4"),
                                   (np.reshape(var, (B, 1)), "<f8")])


def unpack_tlwe_samples(data: bytes, B: int, m: int):
    """Inverse of :func:`pack_tlwe_samples` -> (polys (B, m), var (B,))."""
    polys, var = _unpack(data, B, TLWE_SAMPLE_UID, [(m, "<i4"), (1, "<f8")], "TLweSample")
    return polys, var.ravel()


# ---------------------------------------------------------------------------
# Composite: key-switching key, bootstrapping key, keysets.
# ---------------------------------------------------------------------------

def write_keyswitch_key(f, ks_packed: np.ndarray, variance: float, basebit: int) -> None:
    """LWEKSPARAMS section + the UID-200 record: uid, max-variance f64, the
    packed (n_in, t, base, n_out + 1) table, then uid + variance again."""
    n_in, t, base, m = ks_packed.shape
    write_section(f, "LWEKSPARAMS", {"n": n_in, "t": t, "basebit": basebit})
    f.write(_I32.pack(KEYSWITCH_KEY_UID))
    f.write(_F64.pack(float(variance)))
    f.write(np.ascontiguousarray(ks_packed, "<i4").tobytes())
    f.write(_I32.pack(KEYSWITCH_KEY_UID))
    f.write(_F64.pack(float(variance)))


def read_keyswitch_key(f, n_out: int):
    _, pr = read_section(f, "LWEKSPARAMS")
    n_in, t, basebit = int(pr["n"]), int(pr["t"]), int(pr["basebit"])
    base = 1 << basebit
    (uid,) = _I32.unpack(_read_exact(f, 4))
    if uid != KEYSWITCH_KEY_UID:
        raise ValueError(f"bad LweKeySwitchKey UID {uid}")
    (var,) = _F64.unpack(_read_exact(f, 8))
    count = n_in * t * base * (n_out + 1)
    rows = np.frombuffer(_read_exact(f, 4 * count), "<i4").copy()
    (uid2,) = _I32.unpack(_read_exact(f, 4))
    (var2,) = _F64.unpack(_read_exact(f, 8))
    if uid2 != KEYSWITCH_KEY_UID or var2 != var:
        raise ValueError("bad LweKeySwitchKey trailer")
    return rows.reshape(n_in, t, base, n_out + 1).astype(np.int32), var, basebit


def write_bootstrapping_key(f, bk_rows: np.ndarray, bk_variance: float,
                            ks_packed: np.ndarray, ks_variance: float, basebit: int) -> None:
    """Keyswitch key (LWEKSPARAMS + UID 200), then the UID-201 record: uid,
    max-variance f64, the raw polynomial coefficients."""
    write_keyswitch_key(f, ks_packed, ks_variance, basebit)
    f.write(_I32.pack(BOOTSTRAP_KEY_UID))
    f.write(_F64.pack(float(bk_variance)))
    f.write(np.ascontiguousarray(bk_rows, "<i4").tobytes())


def read_bootstrapping_key(f, n: int, params: GateBootstrappingParams):
    tg = params.tgsw_params
    kpl, k, N = tg.kpl, tg.tlwe_params.k, tg.tlwe_params.N
    ks, ks_var, _ = read_keyswitch_key(f, params.n)
    (uid,) = _I32.unpack(_read_exact(f, 4))
    if uid != BOOTSTRAP_KEY_UID:
        raise ValueError(f"bad LweBootstrappingKey UID {uid}")
    (bk_var,) = _F64.unpack(_read_exact(f, 8))
    count = n * kpl * (k + 1) * N
    bk = np.frombuffer(_read_exact(f, 4 * count), "<i4").copy().reshape(n, kpl, k + 1, N)
    return bk.astype(np.int32), bk_var, ks, ks_var


def _write_cloud(f, cloud, params: GateBootstrappingParams) -> None:
    write_gate_params(f, params)
    bk = cloud.bk
    write_bootstrapping_key(f, to_numpy(bk.bk), float(bk.bk_variance), to_numpy(bk.ks.ks),
                            float(bk.ks.variance), params.ks.basebit)


def export_secret_keyset(keyset, params: GateBootstrappingParams) -> bytes:
    """``export_tfheGateBootstrappingSecretKeySet_toStream``: parameter
    sections, keyswitch key, bootstrapping key, LweKey (43), TGswKey (169)."""
    f = _io.BytesIO()
    _write_cloud(f, keyset.cloud, params)
    write_lwe_key(f, to_numpy(keyset.lwe_key.s))
    write_tgsw_key(f, to_numpy(keyset.tgsw_key.key))
    return f.getvalue()


def import_secret_keyset(data: bytes, device=None):
    """Inverse of :func:`export_secret_keyset` -> (SecretKeySet on ``device``
    (the card by default), params)."""
    from ..core.keys import keyset_from_numpy

    f = _io.BytesIO(data)
    params = read_gate_params(f)
    bk, bk_var, ks, ks_var = read_bootstrapping_key(f, params.n, params)
    s = read_lwe_key(f, params.n)
    tk = read_tgsw_key(f, params.k, params.N)
    return keyset_from_numpy(s, tk, bk, bk_var, ks, ks_var, device=device), params


def export_cloud_keyset(cloud, params: GateBootstrappingParams) -> bytes:
    """The cloud (evaluation) keyset: parameter sections, keyswitch key and
    bootstrapping key (the reference's ``generatePublicKey`` is a stub)."""
    f = _io.BytesIO()
    _write_cloud(f, cloud, params)
    return f.getvalue()


def import_cloud_keyset(data: bytes, device=None):
    """Inverse of :func:`export_cloud_keyset` -> (CloudKeySet on ``device``
    (the card by default), params)."""
    from ..core.keys import BootstrappingKey, CloudKeySet, KeySwitchKey
    from ..device import resolve_device

    dev = resolve_device(device)
    f = _io.BytesIO(data)
    params = read_gate_params(f)
    bk, bk_var, ks, ks_var = read_bootstrapping_key(f, params.n, params)

    def f32(x):
        return torch.tensor(np.float32(x), dtype=torch.float32, device=dev)

    cloud = CloudKeySet(bk=BootstrappingKey(
        bk=torch.from_numpy(bk).to(dev), bk_variance=f32(bk_var),
        ks=KeySwitchKey(ks=torch.from_numpy(ks).to(dev), variance=f32(ks_var))))
    return cloud, params


# ---------------------------------------------------------------------------
# Base64 around every stream.
# ---------------------------------------------------------------------------

_B64_ALPHABET = frozenset("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/")


def b64encode(data: bytes) -> str:
    return base64.b64encode(data).decode()


def b64decode(s: str) -> bytes:
    """The reference's decoder: stops at the first character outside the
    alphabet and tolerates missing padding."""
    end = next((i for i, ch in enumerate(s) if ch not in _B64_ALPHABET), len(s))
    t = s[:end]
    return base64.b64decode(t + "=" * (-len(t) % 4))
