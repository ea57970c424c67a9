"""The reference's two environment switches in the port: the prepared-key cache
(``EOC_NTT_KEY_CACHE``) and the native codec's off switch (``EOC_TFHE_NO_NATIVE``).

Both run on the CPU: the cache keeps the key that ``prepare_eval_key_ntt``
builds on the cloud key's device, and the switch keeps ``native`` unbuilt.
"""

import os

import numpy as np
import pytest
import torch

from eoc_tfhe_tpu_torch import native
from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, params
from eoc_tfhe_tpu_torch.io import tfhe_io
from eoc_tfhe_tpu_torch.ops import ntt

FORMS = {"ntt_kernel": ("auto", "bk_ntt_kernel", "prepare_kernel_key"),
         "ntt_scan": (False, "bk_ntt", "prepare_key_ntt")}


@pytest.fixture(scope="module")
def keyset():
    p = params.test_params(n=8)
    gen = torch.Generator().manual_seed(61)
    return p, keys.new_random_gate_bootstrapping_secret_keyset(gen, p, device="cpu")


A = torch.tensor([False, False, True, True])
B = torch.tensor([False, True, False, True])


def _nand(ek, p, ks, seed):
    gen = torch.Generator().manual_seed(seed)
    ca = gates.encrypt_bit(gen, A, ks.lwe_key, p)
    cb = gates.encrypt_bit(gen, B, ks.lwe_key, p)
    return gates.nand(ca, cb, ek, p)


@pytest.mark.parametrize("form", list(FORMS))
def test_a_cache_hit_gives_the_same_words(form, keyset, tmp_path, monkeypatch):
    p, ks = keyset
    kernel, field, preparer = FORMS[form]
    fresh = bootstrap.prepare_eval_key_ntt(ks.cloud, p, kernel=kernel)
    monkeypatch.setenv("EOC_NTT_KEY_CACHE", str(tmp_path))
    written = bootstrap.prepare_eval_key_ntt(ks.cloud, p, kernel=kernel)
    (name,) = os.listdir(tmp_path)
    assert name.startswith(f"ntt-{'kern' if form == 'ntt_kernel' else 'scan'}-"
                           f"v{ntt.KEY_LAYOUT_VERSION}-") and name.endswith(".npy")

    def no_build(*_):
        raise AssertionError("a cache hit must not rebuild the key")
    monkeypatch.setattr(ntt, preparer, no_build)
    loaded = bootstrap.prepare_eval_key_ntt(ks.cloud, p, kernel=kernel)
    assert loaded.form == form
    for ek in (written, loaded):
        assert torch.equal(getattr(ek, field), getattr(fresh, field))
    want, got = _nand(fresh, p, ks, 62), _nand(loaded, p, ks, 62)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    assert torch.equal(gates.decrypt_bit(got, ks.lwe_key), ~(A & B))


@pytest.mark.parametrize("stale", ["wrong_shape", "wrong_dtype", "truncated"])
def test_a_stale_cache_file_is_rebuilt(stale, keyset, tmp_path, monkeypatch):
    p, ks = keyset
    fresh = bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    monkeypatch.setenv("EOC_NTT_KEY_CACHE", str(tmp_path))
    bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    (name,) = os.listdir(tmp_path)
    path = tmp_path / name
    good = np.load(path)
    if stale == "wrong_shape":
        np.save(path, good.reshape(good.shape[0], -1)[:, :-16])
    elif stale == "wrong_dtype":
        np.save(path, good.astype(np.int16))
    else:
        path.write_bytes(path.read_bytes()[:1000])
    ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    assert torch.equal(ek.bk_ntt_kernel, fresh.bk_ntt_kernel)
    np.testing.assert_array_equal(np.load(path), good)       # the file was replaced
    assert os.listdir(tmp_path) == [name]                    # no temporary file is left


def test_the_cache_is_keyed_by_rows_and_layout(keyset, tmp_path, monkeypatch):
    p, ks = keyset
    monkeypatch.setenv("EOC_NTT_KEY_CACHE", str(tmp_path))
    bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    monkeypatch.setattr(ntt, "KEY_LAYOUT_VERSION", ntt.KEY_LAYOUT_VERSION + 1)
    bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    other = keys.new_random_gate_bootstrapping_secret_keyset(
        torch.Generator().manual_seed(63), p, device="cpu")
    ek = bootstrap.prepare_eval_key_ntt(other.cloud, p)
    assert len(os.listdir(tmp_path)) == 3
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    assert torch.equal(ek.bk_ntt_kernel, ntt.prepare_kernel_key(other.cloud.bk.bk, ctx))


def test_no_native_switch_keeps_the_codec_unbuilt(monkeypatch):
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_error", None)

    def no_build(*_):
        raise AssertionError("EOC_TFHE_NO_NATIVE must not build the library")
    monkeypatch.setattr(native, "_build", no_build)
    monkeypatch.setenv("EOC_TFHE_NO_NATIVE", "1")
    assert native.get_lib() is None and not native.available()
    assert native.build_error is None and native.b64decode("QUJD") is None
    assert tfhe_io.b64decode("QUJDR") == b"ABC"                # the numpy path
