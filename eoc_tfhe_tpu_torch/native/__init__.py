"""Native (C++) host tier: ctypes bindings for the bulk codec.

Port of ``eoc_tfhe_tpu/native``.  Upstream's host runtime is C/C++ (base64
and the tfhe_io record streams); ``codec.cpp`` is the equivalent native tier
here.  It is built with ``g++`` at first use (never at import) into the
port's git-ignored ``_build/`` directory, named by a hash of the source, under
a lock, so threads and processes that start together build it once and load
only a finished file.  Every function here but :func:`b64encode` (which
``binascii`` computes) returns None when the library is unavailable, :func:`available` says whether it is loaded, and
:data:`build_error` says why the build failed.

``io/tfhe_io`` routes only base64 decoding through it (2.2-2.5x faster than the
numpy path on the card's host) and keeps numpy for machines without
``g++``.  The record functions pack and unpack no faster than numpy's
vectorized pass, so ``tfhe_io`` keeps numpy for records and ``chip_smoke.py``
times the two against each other; base64 encoding stays with CPython's
``binascii``, which was faster than the reference's encoder (PERF.md).

Setting ``EOC_TFHE_NO_NATIVE`` (to any non-empty value) before the first use
keeps the library unloaded and unbuilt, as in the reference: the numpy path
runs, and :data:`build_error` stays None.
"""

from __future__ import annotations

import binascii
import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "codec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
#: Why the library is unavailable (the compiler's message), or None.
build_error: str | None = None


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libeoc_native-{digest}.so"


def _build(out: Path) -> bool:
    """Compile into a file of this process's own and move it into place, so
    another process never loads a half-written library.  A failure is kept
    in :data:`build_error` and warned about."""
    global build_error
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
    except subprocess.CalledProcessError as e:
        build_error = f"{' '.join(cmd)} exited {e.returncode}: {e.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"{' '.join(cmd)}: {e}"
    if build_error is not None:
        tmp.unlink(missing_ok=True)
        warnings.warn(f"native codec unavailable, the numpy path runs: {build_error}")
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native codec; None if unavailable or
    switched off by ``EOC_TFHE_NO_NATIVE``."""
    global _lib, _tried, build_error
    with _LOCK:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("EOC_TFHE_NO_NATIVE"):
            return None
        out = _target()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            build_error = f"loading {out}: {e}"
            warnings.warn(f"native codec unavailable, the numpy path runs: {build_error}")
            return None
        c_i64, c_u8p, c_i32p, c_f64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                                        ctypes.POINTER(ctypes.c_int32),
                                        ctypes.POINTER(ctypes.c_double))
        lib.eoc_b64_decode.restype = c_i64
        lib.eoc_b64_decode.argtypes = [ctypes.c_char_p, c_i64, c_u8p]
        lib.eoc_pack_lwe_array.restype = None
        lib.eoc_pack_lwe_array.argtypes = [c_i32p, c_i32p, c_f64p, c_i64, c_i64, c_u8p]
        lib.eoc_unpack_lwe_array.restype = c_i64
        lib.eoc_unpack_lwe_array.argtypes = [c_u8p, c_i64, c_i64, c_i32p, c_i32p, c_f64p]
        lib.eoc_pack_tlwe_array.restype = None
        lib.eoc_pack_tlwe_array.argtypes = [c_i32p, c_f64p, c_i64, c_i64, c_u8p]
        lib.eoc_unpack_tlwe_array.restype = c_i64
        lib.eoc_unpack_tlwe_array.argtypes = [c_u8p, c_i64, c_i64, c_i32p, c_f64p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded: the codec's bulk
    records and base64 then run in C++; False means the numpy path runs."""
    return get_lib() is not None


def _u8(buf):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _records(data: bytes, B: int, size: int, what: str) -> np.ndarray:
    """The first B records of ``size`` bytes as a uint8 view; raises on a
    short stream (the library reads without bounds)."""
    if B < 0 or len(data) < B * size:
        raise ValueError(f"truncated stream: wanted {B} {what} records of {size} bytes")
    return np.frombuffer(data, np.uint8, count=B * size)


def b64encode(data: bytes) -> str:
    """Standard base64 of ``data`` with padding, the reference's
    ``native.b64encode`` output.  ``binascii`` encodes it (faster than the
    library's encoder was), so it needs no build and never returns None."""
    return binascii.b2a_base64(data, newline=False).decode()


def b64decode(s: str) -> bytes | None:
    """Upstream's lenient decode: stops at the first character outside the
    alphabet, tolerates missing padding, drops a lone trailing sextet."""
    lib = get_lib()
    if lib is None:
        return None
    raw = s.encode()
    out = np.empty((len(raw) * 3) // 4 + 3, np.uint8)
    n = lib.eoc_b64_decode(raw, len(raw), _u8(out))
    return out[:int(n)].tobytes()


def pack_lwe_array(a: np.ndarray, b: np.ndarray, var: np.ndarray) -> bytes | None:
    """(B, n) int32, (B,) int32, (B,) float64 -> B UID-42 records."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.int32)
    B, n = a.shape
    b = np.ascontiguousarray(np.reshape(b, B), np.int32)
    var = np.ascontiguousarray(np.reshape(var, B), np.float64)
    out = np.empty(B * (4 + 4 * n + 4 + 8), np.uint8)
    lib.eoc_pack_lwe_array(_i32(a), _i32(b), _f64(var), B, n, _u8(out))
    return out.tobytes()


def unpack_lwe_array(data: bytes, B: int, n: int):
    lib = get_lib()
    if lib is None:
        return None
    src = _records(data, B, 4 + 4 * n + 4 + 8, "LweSample")
    a = np.empty((B, n), np.int32)
    b = np.empty(B, np.int32)
    var = np.empty(B, np.float64)
    bad = lib.eoc_unpack_lwe_array(_u8(src), B, n, _i32(a), _i32(b), _f64(var))
    if bad:
        raise ValueError(f"bad LweSample UID at record {int(bad) - 1}")
    return a, b, var


def pack_tlwe_array(polys: np.ndarray, var: np.ndarray) -> bytes | None:
    """polys: (B, k+1, N) or (B, m) int32, var (B,) float64 -> B UID-169 records."""
    lib = get_lib()
    if lib is None:
        return None
    polys = np.ascontiguousarray(polys, np.int32)
    B = polys.shape[0]
    m = polys.size // B if B else 0
    var = np.ascontiguousarray(np.reshape(var, B), np.float64)
    out = np.empty(B * (4 + 4 * m + 8), np.uint8)
    lib.eoc_pack_tlwe_array(_i32(polys), _f64(var), B, m, _u8(out))
    return out.tobytes()


def unpack_tlwe_array(data: bytes, B: int, m: int):
    lib = get_lib()
    if lib is None:
        return None
    src = _records(data, B, 4 + 4 * m + 8, "TLweSample")
    polys = np.empty((B, m), np.int32)
    var = np.empty(B, np.float64)
    bad = lib.eoc_unpack_tlwe_array(_u8(src), B, m, _i32(polys), _f64(var))
    if bad:
        raise ValueError(f"bad TLweSample UID at record {int(bad) - 1}")
    return polys, var
