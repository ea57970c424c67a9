"""The reference harness of the port's tests (``tests/torch_reference.py``).

Two facts the harness rests on, each checked where it costs seconds: the
reference's exact eval-key forms give one NAND, word for word, so one
reference NAND a shape holds every port form; and a keyset made by either
package's keygen is one key in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import gates as jgates
from eoc_tfhe_tpu.core import params as jparams

from eoc_tfhe_tpu_torch.core import bootstrap, gates

from torch_reference import (assert_nand_matches, keyset_pair, reference_nand, to_port,
                             to_reference)

FORMS_AT = {
    "N16_k1_l3": lambda: jparams.test_params(N=16, k=1, l=3, Bgbit=7, n=4),
    "N1024_k3_l5": lambda: jparams.test_params(N=1024, k=3, l=5, Bgbit=5, n=4),
}


@pytest.mark.parametrize("shape", list(FORMS_AT))
def test_reference_forms_agree_where_exact(shape):
    """Where the gadget digits fit int8 (halfBg <= 128) and the key is not
    rounded, the reference's "rows" and "fused" NANDs, its XLA CRT-NTT scan
    and its Pallas K1 in interpret mode give the same words and variance."""
    p = FORMS_AT[shape]()
    assert p.tgsw_params.halfBg <= 128
    scan = reference_nand(p, 61, "scan").out
    for form in ("rows", "fused", "kernel"):
        out = reference_nand(p, 61, form).out
        for field in ("a", "b", "current_variance"):
            np.testing.assert_array_equal(np.asarray(getattr(out, field)),
                                          np.asarray(getattr(scan, field)), err_msg=form)


@pytest.mark.parametrize("keygen", ["port", "reference"])
def test_keyset_pair_is_the_same_key_in_both_packages(keygen):
    """At ``test_params()`` the keyset of either package's keygen holds the
    same arrays in both packages; each package decrypts the other's
    encryptions; and the two packages' NANDs over it agree word for word."""
    p = jparams.test_params()
    ref, port = keyset_pair(p, 41, keygen)
    bk, jbk = port.cloud.bk, ref.cloud.bk
    for mine, theirs in ((port.lwe_key.s, ref.lwe_key.s), (port.tgsw_key.key, ref.tgsw_key.key),
                         (bk.bk, jbk.bk), (bk.bk_variance, jbk.bk_variance),
                         (bk.ks.ks, jbk.ks.ks), (bk.ks.variance, jbk.ks.variance)):
        assert mine.numpy().dtype == np.asarray(theirs).dtype
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    bits = np.array([True, False, False, True, True, False, True])
    jct = jgates.encrypt_bit(jax.random.key(42), jnp.asarray(bits), ref.lwe_key, p)
    np.testing.assert_array_equal(gates.decrypt_bit(to_port(jct), port.lwe_key).numpy(), bits)
    ct = gates.encrypt_bit(torch.Generator().manual_seed(43), torch.from_numpy(bits),
                           port.lwe_key, p)
    np.testing.assert_array_equal(jgates.decrypt_bit(to_reference(ct), ref.lwe_key), bits)
    nand = reference_nand(p, 41, keygen=keygen)
    assert nand.keys.port is port
    ek = bootstrap.prepare_eval_key_ntt(port.cloud, p)
    assert_nand_matches(gates.nand(to_port(nand.ca), to_port(nand.cb), ek, p), nand.out, port,
                        nand.a, nand.b)
