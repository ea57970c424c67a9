"""The port's native C++ codec against its numpy path and the reference's
codec, case for case with tests/test_native_codec.py.  Every case runs with
the library ("native") and without it ("numpy", the path of a machine
without g++); both give the reference's bytes.  ``tfhe_io`` takes the
library for base64 decoding only, so the record cases call the library's
record functions directly on the native path."""

import base64
import os
import re

import numpy as np
import pytest

from eoc_tfhe_tpu import native as ref_native
from eoc_tfhe_tpu.io import tfhe_io as ref_io
from eoc_tfhe_tpu_torch import native
from eoc_tfhe_tpu_torch.io import tfhe_io

_DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDENS = sorted(f for f in os.listdir(_DATA) if re.fullmatch(r"golden_.*\.bin", f))


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Which codec path the port runs: the built library, or none."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_tried", True)
        monkeypatch.setattr(native, "_lib", None)
    assert native.available() == (request.param == "native")
    return request.param


def records(path):
    """(pack_lwe, unpack_lwe, pack_tlwe, unpack_tlwe) of the path."""
    if path == "native":
        return (native.pack_lwe_array, native.unpack_lwe_array, native.pack_tlwe_array,
                native.unpack_tlwe_array)
    return (tfhe_io.pack_lwe_samples, tfhe_io.unpack_lwe_samples, tfhe_io.pack_tlwe_samples,
            tfhe_io.unpack_tlwe_samples)


def test_native_builds_into_the_ports_build_dir():
    assert native.available(), "g++ codec build failed"
    lib = native.get_lib()
    assert os.path.dirname(lib._name) == str(native.BUILD_DIR)
    assert os.path.basename(lib._name).startswith("libeoc_native-")


def test_a_failed_build_is_kept_and_warned(tmp_path, monkeypatch):
    """When g++ refuses the source, the numpy path runs and build_error
    holds the compiler's message."""
    bad = tmp_path / "codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_error", None)
    with pytest.warns(UserWarning, match="native codec unavailable"):
        assert not native.available()
    assert "exited" in native.build_error and "error" in native.build_error
    assert native.b64decode("QUJD") is None and tfhe_io.b64decode("QUJD") == b"ABC"
    assert not list((tmp_path / "build").glob("*.so"))


def test_b64_matches_stdlib_and_reference_truncation(path):
    rng = np.random.default_rng(0)
    for size in [0, 1, 2, 3, 10, 1000]:
        data = rng.integers(0, 256, size).astype(np.uint8).tobytes()
        assert tfhe_io.b64encode(data) == base64.b64encode(data).decode()
        assert tfhe_io.b64decode(base64.b64encode(data).decode()) == data
    # upstream semantics: stop at the first non-alphabet character, tolerate
    # missing padding, drop a lone trailing character
    assert tfhe_io.b64decode("QUJD!garbage") == b"ABC"
    assert tfhe_io.b64decode("QUJDRA") == b"ABCD"
    assert tfhe_io.b64decode("QUJDR") == b"ABC"


def test_b64_decode_paths_agree_on_any_string(monkeypatch):
    """Both paths and the reference's native decoder give the same bytes on
    random strings over the alphabet, padding and junk."""
    rng = np.random.default_rng(1)
    chars = list("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/") + \
        ["=", "!", "\n", "-"]
    strings = ["".join(rng.choice(chars, size=n, p=None)) for n in range(40) for _ in range(6)]
    strings += ["".join(rng.choice(chars[:64], size=n)) for n in range(40)]
    got_native = [tfhe_io.b64decode(s) for s in strings]
    want = [ref_native.b64decode(s) for s in strings]
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_lib", None)
    got_numpy = [tfhe_io.b64decode(s) for s in strings]
    assert got_native == got_numpy == want


def test_lwe_pack_native_vs_fallback(path):
    rng = np.random.default_rng(1)
    B, n = 37, 630
    a = rng.integers(-2**31, 2**31, (B, n), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, B, dtype=np.int64).astype(np.int32)
    var = rng.random(B)
    pack, unpack, _, _ = records(path)
    got = pack(a, b, var)
    assert got == ref_io.pack_lwe_samples(a, b, var)
    ra, rb, rv = unpack(got, B, n)
    np.testing.assert_array_equal(ra, a)
    np.testing.assert_array_equal(rb, b)
    np.testing.assert_array_equal(rv, var)


def test_tlwe_pack_native_vs_fallback(path):
    rng = np.random.default_rng(2)
    B, k1, N = 12, 2, 64
    polys = rng.integers(-2**31, 2**31, (B, k1, N), dtype=np.int64).astype(np.int32)
    var = rng.random(B)
    _, _, pack, unpack = records(path)
    got = pack(polys, var)
    assert got == ref_io.pack_tlwe_samples(polys, var)
    rp, rv = unpack(got, B, k1 * N)
    np.testing.assert_array_equal(rp, polys.reshape(B, -1))
    np.testing.assert_array_equal(rv, var)


def test_bad_uid_and_truncation_raise(path):
    pack_lwe, unpack_lwe, pack_tlwe, unpack_tlwe = records(path)
    data = bytearray(pack_lwe(np.zeros((2, 4), np.int32), np.zeros(2, np.int32), np.zeros(2)))
    data[0] = 99
    with pytest.raises(ValueError, match="bad LweSample UID at record 0"):
        unpack_lwe(bytes(data), 2, 4)
    with pytest.raises(ValueError, match="truncated stream"):
        unpack_lwe(bytes(data[:-1]), 2, 4)
    tl = pack_tlwe(np.zeros((2, 8), np.int32), np.zeros(2))
    with pytest.raises(ValueError, match="truncated stream"):
        unpack_tlwe(tl[:-8], 2, 8)
    bad = bytearray(tl)
    bad[len(tl) // 2] = 7
    with pytest.raises(ValueError, match="bad TLweSample UID at record 1"):
        unpack_tlwe(bytes(bad), 2, 8)


@pytest.mark.parametrize("name", GOLDENS)
def test_goldens_round_trip_byte_for_byte(path, name):
    """Each tests/data/golden_*.bin through base64 and back, and through the
    codec it holds: the LWE record unpacked and repacked, the keyset imported
    and exported; every step gives the file's bytes."""
    with open(os.path.join(_DATA, name), "rb") as f:
        blob = f.read()
    text = tfhe_io.b64encode(blob)
    assert text == base64.b64encode(blob).decode()
    assert tfhe_io.b64decode(text) == blob
    if name == "golden_lwesample_630.bin":
        pack, unpack, _, _ = records(path)
        assert pack(*unpack(blob, 1, 630)) == blob
    elif name.startswith("golden_secret_keyset"):
        ks, p = tfhe_io.import_secret_keyset(tfhe_io.b64decode(text), device="cpu")
        assert tfhe_io.export_secret_keyset(ks, p) == blob
    else:
        import io as _io
        p = tfhe_io.read_gate_params(_io.BytesIO(blob))
        out = _io.BytesIO()
        tfhe_io.write_gate_params(out, p)
        assert out.getvalue() == blob


def test_c6_reference_b64_paths_disagree_and_the_ports_do_not(monkeypatch):
    """ROADMAP C6: the reference's base64 decode depends on whether its .so
    was built.  For a string whose alphabet prefix leaves one character over
    (length 1 mod 4), its C++ decoder drops the lone 6 bits and its numpy
    fallback raises.  The port's two paths both give the C++ answer."""
    import binascii

    s = "QUJDR"
    assert ref_native.b64decode(s) == b"ABC"
    monkeypatch.setattr(ref_native, "b64decode", lambda *a: None)
    with pytest.raises(binascii.Error):
        ref_io.b64decode(s)
    assert tfhe_io.b64decode(s) == b"ABC"
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_lib", None)
    assert tfhe_io.b64decode(s) == b"ABC"
