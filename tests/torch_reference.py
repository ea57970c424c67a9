"""The one place where the port's tests pair the port with the frozen JAX reference.

A port test that needs the reference takes from here what both packages
share, each made once per process:

- :func:`keyset_pair`: one keyset in both packages, from the port's keygen
  (tests whose subject is not keygen) or the reference's (tests of keygen,
  key noise and key I/O).  Keygen is the expensive part of the reference's
  side: its JAX compile costs 10-20 s at each new shape, the port's keygen
  a second;
- :func:`to_port` and :func:`to_reference`: a ciphertext of one package as
  the other's;
- :func:`reference_nand`: two encrypted bit vectors and the reference's NAND
  of them, over its cheapest exact eval-key form unless a form is named.
  Every exact form gives the same words (the products are exact negacyclic
  products mod 2^32), so one reference NAND a shape holds every port form;
  ``tests/test_torch_reference_harness.py`` checks the forms agree;
- :func:`rotation_inputs` and :func:`reference_scan`: random TGSW rows,
  accumulators and rotations, and the reference's exact scan over them;
- :func:`assert_same_ct`, :func:`assert_nand_matches` and
  :func:`assert_port_nand_matches`: the port's ciphertexts against the
  reference's.

Importing this module also gives torch's CPU thread pool this process's
share of the cores.  Under ``pytest -n W`` each of the W workers would
otherwise start a pool of every core: six workers on 8 cores ran an
emulation test in 105 s that takes 3 s with a pool of one thread each.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import gates as jgates
from eoc_tfhe_tpu.core import keys as jkeys
from eoc_tfhe_tpu.core import lwe as jlwe
from eoc_tfhe_tpu.core import tlwe as jtlwe
from eoc_tfhe_tpu.ops import ntt as jntt

from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, lwe

from torch_reference_ntt import fast_reference_matrices


def _share_the_cores() -> None:
    """One worker of ``pytest -n W`` takes 1/W of the cores for torch."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))


_share_the_cores()

#: The bit vectors of every reference NAND: all four input pairs.
BITS_A = np.array([False, False, True, True, False, True])
BITS_B = np.array([False, True, False, True, True, True])

#: Up to this ring the reference's "rows" NAND is its cheapest exact form;
#: past it the fused one (Pallas K2 in interpret mode).  The first NAND of a
#: process at n = 4 on an 8-core CPU host: rows 0.4-3.7 s and fused 2.4-8.3 s
#: at the C8 and C10 shapes up to N = 4096, but rows 13.6 s and fused 4.9 s
#: at N = 4096 k = 2 l = 6; the scan 5.9-28.4 s at every shape.
ROWS_UP_TO_N = 2048


class KeysetPair(NamedTuple):
    ref: jkeys.SecretKeySet
    port: keys.SecretKeySet


def port_keyset(jk: jkeys.SecretKeySet) -> keys.SecretKeySet:
    """The reference's keyset as the port's, on the CPU."""
    bk = jk.cloud.bk
    return keys.keyset_from_numpy(
        np.asarray(jk.lwe_key.s), np.asarray(jk.tgsw_key.key), np.asarray(bk.bk),
        np.asarray(bk.bk_variance), np.asarray(bk.ks.ks), np.asarray(bk.ks.variance),
        device="cpu")


def reference_keyset(tk: keys.SecretKeySet) -> jkeys.SecretKeySet:
    """The port's keyset as the reference's, in its own key dataclasses."""
    bk = tk.cloud.bk

    def j(x):
        return jnp.asarray(x.cpu().numpy())

    ks = jkeys.KeySwitchKey(ks=j(bk.ks.ks), variance=j(bk.ks.variance))
    return jkeys.SecretKeySet(
        lwe_key=jlwe.LweKey(s=j(tk.lwe_key.s)), tgsw_key=jtlwe.TLweKey(key=j(tk.tgsw_key.key)),
        cloud=jkeys.CloudKeySet(bk=jkeys.BootstrappingKey(bk=j(bk.bk),
                                                          bk_variance=j(bk.bk_variance), ks=ks)))


def keyset_pair(params, seed: int, keygen: str = "port") -> KeysetPair:
    """One keyset in both packages, made once a process by the port's keygen
    from ``torch.Generator().manual_seed(seed)`` or, with
    ``keygen="reference"``, by the reference's from ``jax.random.key(seed)``."""
    return _keyset_pair(params, seed, keygen)


@functools.lru_cache(maxsize=None)
def _keyset_pair(params, seed: int, keygen: str) -> KeysetPair:
    if keygen == "port":
        tk = keys.new_random_gate_bootstrapping_secret_keyset(
            torch.Generator().manual_seed(seed), params, device="cpu")
        return KeysetPair(ref=reference_keyset(tk), port=tk)
    if keygen == "reference":
        jk = jkeys.new_random_gate_bootstrapping_secret_keyset(jax.random.key(seed), params)
        return KeysetPair(ref=jk, port=port_keyset(jk))
    raise ValueError(f"keygen must be 'port' or 'reference'; got {keygen!r}")


def to_port(ct):
    """A reference ciphertext, plain or seeded, as the port's (CPU tensors)."""
    def t(x):
        return torch.from_numpy(np.array(x))
    if isinstance(ct, jlwe.SeededLweCiphertext):
        return lwe.SeededLweCiphertext(seed=t(np.asarray(ct.seed).astype(np.int64)), b=t(ct.b),
                                       current_variance=t(ct.current_variance))
    return lwe.LweCiphertext(a=t(ct.a), b=t(ct.b), current_variance=t(ct.current_variance))


def to_reference(ct: lwe.LweCiphertext) -> jlwe.LweCiphertext:
    """A port ciphertext as the reference's."""
    return jlwe.LweCiphertext(*(jnp.asarray(x.cpu().numpy())
                                for x in (ct.a, ct.b, ct.current_variance)))


def exact_form(params) -> str:
    """The reference's cheapest eval-key form whose NAND is exact at ``params``:
    "rows" up to ``ROWS_UP_TO_N`` where its int32 sum bound holds, else
    "fused"; both cast the gadget digits to int8, so past halfBg = 128
    (ROADMAP C1) the scan."""
    tg = params.tgsw_params
    N = tg.tlwe_params.N
    if tg.halfBg > 128:
        return "scan"
    if N <= ROWS_UP_TO_N and tg.kpl * N * tg.halfBg * 128 < 1 << 31:
        return "rows"
    return "fused"


def reference_eval_key(cloud, params, form: str):
    """The reference's eval key in ``form``: "rows", "fused", "scan" (its
    XLA CRT-NTT scan) or "kernel" (its Pallas K1 in interpret mode)."""
    if form == "rows":
        return jboot.prepare_eval_key(cloud)
    if form == "fused":
        return jboot.prepare_eval_key_fused(cloud)
    if form in ("scan", "kernel"):
        return jboot.prepare_eval_key_ntt(cloud, params, kernel=form == "kernel")
    raise ValueError(f"unknown reference form {form!r}")


class ReferenceNand(NamedTuple):
    params: object
    keys: KeysetPair
    a: np.ndarray
    b: np.ndarray
    ca: jlwe.LweCiphertext
    cb: jlwe.LweCiphertext
    out: jlwe.LweCiphertext
    form: str


def reference_nand(params, seed: int, form: str | None = None,
                   keygen: str = "port") -> ReferenceNand:
    """``keyset_pair(params, seed, keygen)``, :data:`BITS_A` and :data:`BITS_B`
    encrypted by the reference (``jax.random.key(seed + 1)`` and ``seed +
    2``), and the reference's NAND of them over ``form`` (default
    :func:`exact_form`; its NTT matrices at F >= 1024 from
    ``tests/torch_reference_ntt.py``), made once a process."""
    return _reference_nand(params, seed, form or exact_form(params), keygen)


@functools.lru_cache(maxsize=None)
def _reference_nand(params, seed: int, form: str, keygen: str) -> ReferenceNand:
    kp = keyset_pair(params, seed, keygen)
    with fast_reference_matrices():
        ca = jgates.encrypt_bit(jax.random.key(seed + 1), jnp.asarray(BITS_A), kp.ref.lwe_key,
                                params)
        cb = jgates.encrypt_bit(jax.random.key(seed + 2), jnp.asarray(BITS_B), kp.ref.lwe_key,
                                params)
        out = jgates.nand(ca, cb, reference_eval_key(kp.ref.cloud, params, form), params)
    return ReferenceNand(params, kp, BITS_A, BITS_B, ca, cb, out, form)


def assert_same_ct(ref, out: lwe.LweCiphertext) -> None:
    """The port's ciphertext ``out`` has the reference's words, and its
    variance to float32 rounding (both packages compute it in float32)."""
    np.testing.assert_array_equal(out.a.numpy(), np.asarray(ref.a))
    np.testing.assert_array_equal(out.b.numpy(), np.asarray(ref.b))
    np.testing.assert_allclose(out.current_variance.numpy(), np.asarray(ref.current_variance),
                               rtol=1e-6)


def assert_nand_matches(out: lwe.LweCiphertext, ref, tk: keys.SecretKeySet, a, b) -> None:
    """The port's NAND ``out`` is the reference's ``ref`` (:func:`assert_same_ct`)
    and decrypts under ``tk`` to NAND(a, b)."""
    assert_same_ct(ref, out)
    np.testing.assert_array_equal(gates.decrypt_bit(out, tk.lwe_key).numpy(), ~(a & b))


def port_eval_key(cloud: keys.CloudKeySet, params, form: str):
    """The port's eval key in ``form``: "compact" (K2), "ntt_kernel" (K1) or
    "ntt_scan" (K3)."""
    if form == "compact":
        ek = bootstrap.prepare_eval_key_fused(cloud, params)
    else:
        ek = bootstrap.prepare_eval_key_ntt(cloud, params, kernel=form == "ntt_kernel")
    assert ek.form == form
    return ek


def assert_port_nand_matches(ref: ReferenceNand, form: str) -> None:
    """The port's NAND of ``ref``'s ciphertexts over its ``form`` eval key
    against the reference's NAND ``ref``."""
    tk = ref.keys.port
    out = gates.nand(to_port(ref.ca), to_port(ref.cb), port_eval_key(tk.cloud, ref.params, form),
                     ref.params)
    assert_nand_matches(out, ref.out, tk, ref.a, ref.b)


def rotation_inputs(params, n_steps: int, batch: int, seed: int):
    """Random TGSW rows (n_steps, J, U, N), accumulators (batch, U, N) and
    rotations (n_steps, batch), the blind rotations' test inputs: the
    rotation is exact for any rows."""
    tg = params.tgsw_params
    N, U = tg.tlwe_params.N, tg.tlwe_params.k + 1
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2**31, 2**31, (n_steps, tg.kpl, U, N), dtype=np.int64).astype(np.int32)
    acc0 = rng.integers(-2**31, 2**31, (batch, U, N), dtype=np.int64).astype(np.int32)
    bara = rng.integers(0, 2 * N, (n_steps, batch), dtype=np.int64).astype(np.int32)
    return rows, acc0, bara


def reference_scan(params, n_steps: int, batch: int, seed: int):
    """``rotation_inputs(params, n_steps, batch, seed)`` and the reference's
    exact XLA scan over them (``ntt.blind_rotate_ntt`` on its
    ``DEFAULT_PRIMES`` context), made once a process; every exact dataflow,
    either prime pair included, gives these words."""
    rows, acc0, bara, want = _reference_scan(params, n_steps, batch, seed)
    return rows.copy(), acc0.copy(), bara.copy(), want


@functools.lru_cache(maxsize=None)
def _reference_scan(params, n_steps: int, batch: int, seed: int):
    rows, acc0, bara = rotation_inputs(params, n_steps, batch, seed)
    with fast_reference_matrices():
        sctx = jntt.context_for_params(params)
        want = np.asarray(jntt.blind_rotate_ntt(
            jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), params,
            sctx))
    return rows, acc0, bara, want
