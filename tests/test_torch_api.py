"""The port's ``Tfhe.*`` API, wire codec, seeded masks and JWT gate against the JAX package.

The wire format is shared, so blobs must be byte-identical: the codec's
records, the golden fixtures in ``tests/data``, keysets and ciphertexts
exported by one package and imported by the other.  Seeded masks are a wire
format too: the port's threefry expansion must give the reference's masks
for the same seeds (with ``jax_threefry_partitionable`` at its default, on;
ROADMAP C4).  The API vectors are the reference's six integration tests.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu import config as jconfig
from eoc_tfhe_tpu.api import jwt as jjwt
from eoc_tfhe_tpu.api import tfhe as jtfhe
from eoc_tfhe_tpu.core import keys as jkeys
from eoc_tfhe_tpu.core import lwe as jlwe
from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.io import tfhe_io as jio

import eoc_tfhe_tpu_torch
from eoc_tfhe_tpu_torch import config
from eoc_tfhe_tpu_torch.api import jwt
from eoc_tfhe_tpu_torch.api.tfhe import Tfhe, TfheSession
from eoc_tfhe_tpu_torch.core import gates, lwe, params
from eoc_tfhe_tpu_torch.io import tfhe_io
from eoc_tfhe_tpu_torch.utils import profiling

P = params.test_params()
_DATA = os.path.join(os.path.dirname(__file__), "data")


def _seeds(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# --- seeded masks (C4) ---------------------------------------------------------

@pytest.fixture
def threefry_flag():
    """Restores ``jax_threefry_partitionable`` after a test that sets it."""
    old = jax.config.jax_threefry_partitionable
    yield
    jax.config.update("jax_threefry_partitionable", old)


def test_threefry_masks_match_reference_with_the_flag_on(threefry_flag):
    seeds = _seeds(1, (3, 2, 4))
    jax.config.update("jax_threefry_partitionable", True)
    want = np.asarray(jlwe._expand_mask(jnp.asarray(seeds), 630))
    got = lwe._expand_mask(torch.from_numpy(seeds.astype(np.int64)), 630)
    assert got.dtype == torch.int32 and got.shape == (3, 2, 630)
    np.testing.assert_array_equal(got.numpy(), want)
    key = seeds.reshape(-1, 4)[0, :2]
    np.testing.assert_array_equal(
        lwe.threefry2x32(torch.from_numpy(key.astype(np.int64)), 5).numpy(),
        np.asarray(jax.random.bits(jax.random.wrap_key_data(jnp.asarray(key),
                                                            impl="threefry2x32"),
                                   (5,), jnp.uint32)))


def test_c4_reference_masks_depend_on_the_ambient_flag(threefry_flag):
    """ROADMAP C4: the reference's expansion follows the ambient flag; the
    port's is fixed to the flag's default layout."""
    seeds = _seeds(2, (4, 4))
    got = lwe._expand_mask(torch.from_numpy(seeds.astype(np.int64)), 64).numpy()
    jax.config.update("jax_threefry_partitionable", False)
    off = np.asarray(jlwe._expand_mask(jnp.asarray(seeds), 64))
    assert not np.array_equal(off, got)
    jax.config.update("jax_threefry_partitionable", True)
    np.testing.assert_array_equal(np.asarray(jlwe._expand_mask(jnp.asarray(seeds), 64)), got)


def test_seeded_encryption_decrypts_and_expands_on_its_device():
    gen = torch.Generator().manual_seed(3)
    s = lwe.lwe_key_gen(gen, P.in_out_params)
    bits = torch.tensor([0, 1, 1, 0, 1], dtype=torch.bool)
    ct = gates.encrypt_bit_seeded(gen, bits, s, P)
    assert ct.seed.shape == (5, 4) and int(ct.seed.max()) < 2**32 and int(ct.seed.min()) >= 0
    full = lwe.lwe_seeded_expand(ct, P.n)
    assert torch.equal(gates.decrypt_bit(full, s), bits)
    mu = torch.tensor(gates.MU_BOOL, dtype=torch.int32)
    np.testing.assert_array_equal(
        lwe.lwe_sym_decrypt(lwe.LweCiphertext(full.a, full.b, full.current_variance), s, 8),
        np.where(bits.numpy(), int(mu), -int(mu)))


# --- the wire codec --------------------------------------------------------------

def test_record_blobs_are_byte_identical():
    rng = np.random.default_rng(4)
    B, n = 5, 630
    a = rng.integers(-2**31, 2**31, (B, n), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, B, dtype=np.int64).astype(np.int32)
    var = rng.random(B)
    seed = _seeds(5, (B, 4))
    blob = tfhe_io.pack_lwe_samples(a, b, var)
    assert blob == jio.pack_lwe_samples(a, b, var)
    for x, y in zip(tfhe_io.unpack_lwe_samples(blob, B, n), (a, b, var)):
        np.testing.assert_array_equal(x, y)
    sblob = tfhe_io.pack_seeded_lwe_samples(seed, b, var)
    assert sblob == jio.pack_seeded_lwe_samples(seed, b, var)
    assert len(sblob) == B * tfhe_io.SEEDED_LWE_SAMPLE_BYTES
    for x, y in zip(tfhe_io.unpack_seeded_lwe_samples(sblob, B), (seed, b, var)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="UID"):
        tfhe_io.unpack_seeded_lwe_samples(blob[:B * tfhe_io.SEEDED_LWE_SAMPLE_BYTES], B)
    polys = a.reshape(B, 2, n // 2)
    tblob = tfhe_io.pack_tlwe_samples(polys, var)
    assert tblob == jio.pack_tlwe_samples(polys, var)
    np.testing.assert_array_equal(tfhe_io.unpack_tlwe_samples(tblob, B, n)[0], a)
    f, g = io.BytesIO(), io.BytesIO()
    tfhe_io.write_lwe_sample(f, a[0], int(b[0]), var[0])
    jio.write_lwe_sample(g, a[0], int(b[0]), var[0])
    assert f.getvalue() == g.getvalue() == blob[:tfhe_io.lwe_sample_num_bytes(n)]
    for s in ("aGVsbG8", "aGVsbG8=====junk", ""):
        assert tfhe_io.b64decode(s) == jio.b64decode(s)
    assert tfhe_io.b64encode(blob) == jio.b64encode(blob)
    with pytest.raises(ValueError, match="truncated"):
        tfhe_io.read_lwe_sample(io.BytesIO(blob[:100]), n)


def test_golden_blobs_round_trip():
    def golden(name):
        with open(os.path.join(_DATA, name), "rb") as f:
            return f.read()

    want = golden("golden_gateparams_128.bin")
    f = io.BytesIO()
    tfhe_io.write_gate_params(f, params.default_128bit_params())
    assert f.getvalue() == want
    back = tfhe_io.read_gate_params(io.BytesIO(want))
    g = io.BytesIO()
    tfhe_io.write_gate_params(g, back)
    assert g.getvalue() == want

    want = golden("golden_lwesample_630.bin")
    a, b, var = tfhe_io.read_lwe_sample(io.BytesIO(want), 630)
    f = io.BytesIO()
    tfhe_io.write_lwe_sample(f, a, b, var)
    assert f.getvalue() == want

    want = golden("golden_secret_keyset_toy.bin")
    ks, p = tfhe_io.import_secret_keyset(want, device="cpu")
    assert p == P and ks.lwe_key.s.device.type == "cpu"
    assert tfhe_io.export_secret_keyset(ks, p) == want
    cloud, p2 = tfhe_io.import_cloud_keyset(tfhe_io.export_cloud_keyset(ks.cloud, p),
                                            device="cpu")
    assert p2 == P and torch.equal(cloud.bk.bk, ks.cloud.bk.bk)


def test_keysets_cross_both_ways_byte_identical():
    p = jparams.test_params()
    jk = jkeys.new_random_gate_bootstrapping_secret_keyset(jax.random.key(6), p)
    blob = jio.export_secret_keyset(jk, p)
    ks, p2 = tfhe_io.import_secret_keyset(blob, device="cpu")
    assert tfhe_io.export_secret_keyset(ks, p2) == blob
    assert tfhe_io.export_cloud_keyset(ks.cloud, p2) == jio.export_cloud_keyset(jk.cloud, p)


# --- the API against the reference ---------------------------------------------------

@pytest.fixture(scope="module")
def sessions():
    """A JAX session with a key and the port's session over the same key."""
    ref = jtfhe.TfheSession(params=jparams.test_params(), seed=7,
                            config=jconfig.FrameworkConfig(param_set="test"))
    blob = ref.generate_secret_key()
    port = TfheSession(config=config.FrameworkConfig(param_set="test"), seed=8, device="cpu")
    port.import_secret_key(blob)
    return ref, port, blob


def _bytes_of(b64, n):
    return tfhe_io.unpack_lwe_samples(tfhe_io.b64decode(b64), 8, n)


def test_uint8_circuits_match_reference_and_decrypt_there(sessions):
    ref, port, blob = sessions
    assert port.generate_secret_key() == blob            # the imported key, re-exported
    assert port.generate_public_key() == ref.generate_public_key()
    n = port.params.n
    ca, cb = ref.encrypt_uint8_bits(200), ref.encrypt_uint8_bits_seeded(100)
    for name, want in (("add_uint8_bits", 44), ("subtract_uint8_bits", 100)):
        mine = getattr(port, name)(ca, cb)
        theirs = getattr(ref, name)(ca, cb)
        (a1, b1, v1), (a2, b2, v2) = _bytes_of(mine, n), _bytes_of(theirs, n)
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)
        np.testing.assert_allclose(v1, v2, rtol=1e-6)   # both compute it in float32
        assert ref.decrypt_uint8_bits(mine) == want == port.decrypt_uint8_bits(mine)
    # the port's uploads, full and seeded, decrypt on the reference and back
    for ct in (port.encrypt_uint8_bits(77), port.encrypt_uint8_bits_seeded(77)):
        assert ref.decrypt_uint8_bits(ct) == 77 == port.decrypt_uint8_bits(ct)
    assert ref.decrypt_integer(port.encrypt_integer(1234)) == 1234
    assert port.decrypt_integer(ref.encrypt_integer(4321)) == 4321
    assert port.decrypt_ascii_string(ref.encrypt_ascii_string("TFHE"), 4) == "TFHE"


@pytest.fixture(scope="module")
def tfhe():
    t = Tfhe(params=P, device="cpu")
    assert t.generateSecretKey("header.payload", "") is not None
    return t


def test_reference_vectors(tfhe):
    # the reference's six integration tests: load, info + JWT, 42, a string,
    # 15 + 27, 50 - 8 (and the 58 its Lua layer gives by aliasing to add)
    assert "TFHE Library" in tfhe.info() and tfhe.testJWT()
    assert tfhe.decryptInteger(tfhe.encryptInteger(42, ""), "", "e30.e30", "") == 42
    assert tfhe.decryptInteger(tfhe.encryptInteger_dummy(42, ""), "", "e30.e30", "") == 42
    msg = "Hello TFHE!"
    ct = tfhe.encryptASCIIString(msg, len(msg), "")
    assert tfhe.decryptASCIIString(ct, len(msg), "", "e30.e30", "") == msg
    s = tfhe.addCiphertexts(tfhe.encryptInteger(15, ""), tfhe.encryptInteger(27, ""), "")
    assert tfhe.decryptInteger(s, "", "e30.e30", "") == 42
    c1, c2 = tfhe.encryptInteger(50, ""), tfhe.encryptInteger(8, "")
    assert tfhe.decryptInteger(tfhe.subtractCiphertexts(c1, c2, ""), "", "e30.e30", "") == 42
    assert tfhe.decryptInteger(tfhe.addCiphertexts(c1, c2, ""), "", "e30.e30", "") == 58
    assert len(tfhe.generatePublicKey()) > 100


def test_uint8_api(tfhe):
    a, b = tfhe.encryptUint8Seeded(50), tfhe.encryptUint8(200)
    for op, want in (("addUint8", 250), ("subtractUint8", 106), ("multiplyUint8", 16),
                     ("lessThanUint8", 1), ("equalsUint8", 0)):
        assert tfhe.decryptUint8(getattr(tfhe, op)(a, b)) == want, op
    assert tfhe.decryptUint8(tfhe.equalsUint8(a, a)) == 1
    lt = tfhe.lessThanUint8(a, b)
    assert tfhe.decryptUint8(tfhe.selectUint8(lt, a, b)) == 50
    assert tfhe.decryptUint8(tfhe.addUint8(lt, a)) == 51
    with pytest.raises(PermissionError):
        tfhe.decryptUint8(a, "", "")


def test_jwt_gate_and_quirks_match_reference():
    t = Tfhe(params=P, device="cpu")
    for token in ("", "no-dot-token", ".leading", "trailing."):
        assert t.generateSecretKey(token, "") is None
    assert t.generateSecretKey("ok.token", "") is not None
    assert Tfhe(params=P, device="cpu").decryptInteger("QUJD", "", "bad token!", "") == -1
    for token in ("aaa.bbb", "", "aaa", "a.b.c", "HEADER-_=.PAYLOAD-_=", "x.y!"):
        assert jwt.validate_jwt(token) == jjwt.validate_jwt(token)
    assert not jwt.verify_rs256("a.b.c", '{"keys": []}')
    off = Tfhe(params=P, device="cpu", config=config.FrameworkConfig(enable_jwt=False))
    assert off.generateSecretKey("", "") is not None
    rs = Tfhe(params=P, device="cpu", config=config.FrameworkConfig(jwt_rs256=True))
    assert rs.generateSecretKey("ok.token", "{}") is None


def test_session_key_reimport_resets_the_gate_api():
    s1 = TfheSession(params=P, seed=7, device="cpu")
    blob = s1.generate_secret_key()
    ct = s1.encrypt_integer(1234)
    s2 = TfheSession(params=P, seed=9, device="cpu")
    s2.generate_secret_key()
    api = s2.gate_api()
    s2.import_secret_key(blob)
    assert s2.decrypt_integer(ct) == 1234
    assert s2.gate_api() is not api
    with pytest.raises(RuntimeError, match="not initialized"):
        TfheSession(params=P, device="cpu").encrypt_integer(1)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Tfhe, TfheSession, eoc_tfhe_tpu_torch.Tfhe):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(params=P)
    with open(os.path.join(_DATA, "golden_secret_keyset_toy.bin"), "rb") as f:
        blob = f.read()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfhe_io.import_secret_keyset(blob)


def test_op_timer_and_profile_echo(capsys):
    profiling.PROFILER.reset()
    with profiling.op_timer("x"):
        pass
    assert profiling.PROFILER.summary()["x"]["calls"] == 1
    config.FrameworkConfig(profile_echo=True).apply_profiling()
    try:
        with profiling.op_timer("y"):
            pass
        assert "y completed in" in capsys.readouterr().out
    finally:
        config.FrameworkConfig().apply_profiling()
    assert not profiling.PROFILER.echo
