"""The reference's NTT matrices at F >= 1024, built in seconds, for the tests.

``eoc_tfhe_tpu.ops.ntt._ntt_matrices_np`` builds W[t, f] = psi^((2f+1)t)
and Winv[f, t] = F^-1 psi^-((2f+1)t) mod p one Python ``pow`` at a time: 11 s
a prime at F = 1024 and 22 s at F = 2048 on one core.  The tests that hold
the port against the reference at N = 8192 and 16384 build the same matrices
from a table of the 2F powers of psi (psi has order 2F) instead, and check
their entries at random (t, f) against the reference's own ``pow`` formula;
below F = 1024 the reference's function runs unchanged.  The two
constructions agree entry for entry at every smaller F that the tests use
(``tests/test_torch_blind_rotate.py::test_context_matches_reference`` and
``tests/test_torch_blind_rotate_c10.py::test_fast_ntt_matrices_match_the_references``).
"""

import contextlib
import functools
from unittest import mock

import numpy as np

from eoc_tfhe_tpu.ops import ntt as jntt

#: From this F on the table construction stands in for the reference's.
FAST_FROM_F = 1024
#: Entries of each matrix checked against the reference's formula.
SPOT_CHECKS = 256
#: The reference's own construction, which stays in use below FAST_FROM_F.
_REFERENCE = jntt._ntt_matrices_np


def table_matrices(p: int, F: int) -> tuple[np.ndarray, np.ndarray]:
    """(W, Winv) as the reference's ``_ntt_matrices_np``, from the 2F powers
    of its root psi (``jntt._root_of_unity``)."""
    psi = jntt._root_of_unity(p, 2 * F)
    psi_inv, Finv = pow(psi, p - 2, p), pow(F, p - 2, p)
    pw, pw_inv = np.ones(2 * F, dtype=np.int64), np.ones(2 * F, dtype=np.int64)
    for e in range(1, 2 * F):
        pw[e], pw_inv[e] = pw[e - 1] * psi % p, pw_inv[e - 1] * psi_inv % p
    t = np.arange(F, dtype=np.int64)[:, None]
    f = np.arange(F, dtype=np.int64)[None, :]
    W = pw[(2 * f + 1) * t % (2 * F)]
    Winv = Finv * pw_inv[(2 * f.T + 1) * t.T % (2 * F)] % p
    rng = np.random.default_rng(F + p)
    for tt, ff in rng.integers(0, F, (SPOT_CHECKS, 2)):
        tt, ff = int(tt), int(ff)
        assert W[tt, ff] == pow(psi, (2 * ff + 1) * tt, p)
        assert Winv[ff, tt] == Finv * pow(psi_inv, (2 * ff + 1) * tt, p) % p
    return jntt._balanced_np(W, p), jntt._balanced_np(Winv, p)


@functools.lru_cache(maxsize=None)
def _matrices(p: int, F: int) -> tuple[np.ndarray, np.ndarray]:
    return table_matrices(p, F) if F >= FAST_FROM_F else _REFERENCE(p, F)


@contextlib.contextmanager
def fast_reference_matrices():
    """Within this block the reference builds its NTT matrices at F >= 1024
    by :func:`table_matrices`."""
    with mock.patch.object(jntt, "_ntt_matrices_np", _matrices):
        yield
