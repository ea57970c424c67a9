"""ROADMAP C10: the shapes the kernels took only after C10, against the JAX package.

One sample past a block (N = 8192 and 16384; F = 512 at Kp = 144), K = 288,
k = 5 and N = 16 and 8, each of which the card refused after C8: the port's
NAND over every form with a kernel there, word for word against one
reference NAND of the shape (``tests/torch_reference.py``, on a keyset of
the port's keygen), and the plans the launchers pick.  The shapes before
C10 are ``tests/test_torch_blind_rotate.py``.
"""

import numpy as np
import pytest

from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.ops import ntt as jntt

from eoc_tfhe_tpu_torch.ops import ntt

from torch_emulation import check_kernel_domains
from torch_reference import assert_port_nand_matches, reference_nand
from torch_reference_ntt import table_matrices


#: ROADMAP C10: a shape of each class the card refused after C8 (n = 4).
C10_CASES = {
    "N8192_k1_l3": lambda: jparams.test_params(N=8192, k=1, l=3, Bgbit=7, n=4),
    "N16384_k1_l3": lambda: jparams.test_params(N=16384, k=1, l=3, Bgbit=7, n=4),
    "N4096_k2_l6_bg4": lambda: jparams.test_params(N=4096, k=2, l=6, Bgbit=4, n=4),
    "N1024_k3_l9_bg3": lambda: jparams.test_params(N=1024, k=3, l=9, Bgbit=3, n=4),
    "N256_k5_l3": lambda: jparams.test_params(N=256, k=5, l=3, Bgbit=7, n=4),
    "N16_k1_l3": lambda: jparams.test_params(N=16, k=1, l=3, Bgbit=7, n=4),
    "N8_k1_l2": lambda: jparams.test_params(N=8, k=1, l=2, Bgbit=8, n=4),
}
#: The C10 NANDs held word for word: every shape over ntt_scan (K3) and
#: compact (K2), and over ntt_kernel (K1) where K1 has a context (N < 4096).
C10_NAND = ([(c, "ntt_scan") for c in C10_CASES] + [(c, "compact") for c in C10_CASES]
            + [(c, "ntt_kernel") for c in ("N1024_k3_l9_bg3", "N16_k1_l3", "N8_k1_l2")])


@pytest.mark.parametrize("shape,form", C10_NAND)
def test_c10_nand_matches_reference_word_for_word(shape, form):
    """ROADMAP C10: at N = 8192 and 16384 (F = 1024 and 2048: K3 and K2 in a
    cluster or at one sample a block), at k = 2 l = 6 (Kp = 144 at F = 512),
    K = 288, k = 5 (U = 6) and N = 16 and 8 (F = 4) the port's NAND has the words,
    the variance rail and the decryption of the shape's one reference NAND
    (its NTT matrices at F >= 1024 from ``tests/torch_reference_ntt.py``)."""
    assert_port_nand_matches(reference_nand(C10_CASES[shape](), 71), form)


C10_DOMAIN = {
    # shape: (K1 plan or None where K1 has no context, K3 plan, K2 plan); the
    # last entry of each plan is the blocks a cluster
    "N8192_k1_l3": (None, (1, True, 2), (1, 1, 3, 1)),
    "N16384_k1_l3": (None, (1, True, 4), (1, 1, 1, 2)),
    "N4096_k2_l6_bg4": (None, (1, True, 2), (1, 1, 4, 1)),
    "N1024_k3_l9_bg3": ((2, True, 1), (1, True, 1), (4, 1, 2, 1)),
    "N256_k5_l3": ((8, True, 1), (8, True, 1), (8, 1, 18, 1)),
    "N16_k1_l3": ((8, True, 1), (8, True, 1), (8, 4, 6, 1)),
    "N8_k1_l2": ((8, True, 1), (8, True, 1), (8, 4, 4, 1)),
}


@pytest.mark.parametrize("case", list(C10_DOMAIN))
def test_kernel_domains_take_the_c10_shapes(case):
    """The C10 shapes are in every domain that has a context there, at the
    plans the launchers pick: K3 in a cluster of 2 at N = 8192 and at F =
    512 with Kp = 144 and of 4 at N = 16384, K2 at one sample a block (N =
    8192, k = 2 l = 6) and in a cluster of 2 (N = 16384), K = 288 in the
    general instantiations, U = 6 and N = 16 in K2's general kernel; each
    block's shared memory within the card's."""
    check_kernel_domains(C10_CASES[case](), *C10_DOMAIN[case])


def test_fast_ntt_matrices_match_the_references():
    """The port's NTT matrices (a table of the 2F powers of psi) and the
    tests' stand-in for the reference's at F >= 1024 equal the reference's
    ``pow``-built ones at every F up to 256 of every prime with a root, and
    the port's equal the stand-in's at F = 1024 and 2048."""
    for prime in (*ntt.DEFAULT_PRIMES, *ntt.KERNEL_PRIMES):
        for F in (4, 8, 16, 32, 64, 128, 256):
            if (prime - 1) % (2 * F):
                continue
            want = jntt._ntt_matrices_np(prime, F)
            for got in (ntt._ntt_matrices_np(prime, F), table_matrices(prime, F)):
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
    for F in (1024, 2048):
        for prime in ntt.DEFAULT_PRIMES:
            for got, want in zip(ntt._ntt_matrices_np(prime, F), table_matrices(prime, F)):
                np.testing.assert_array_equal(got, want)
