"""K2's direct negacyclic product on byte limbs, emulated limb by limb, against the JAX package.

``csrc/blind_rotate_compact.cu`` (K2) runs only on the card.  Its exactness
rests on the byte limbs of the key and on bounds for the int32 limb sums of
each pass.  The emulations of ``tests/torch_emulation.py`` repeat that
arithmetic in torch on the CPU, tier by tier (the instantiations, the row
shares, the cluster's output split and the staged tier), every limb sum
asserted inside int32; here they are held bit for bit against the
reference's exact scans.  K1's and K3's emulations are
``tests/test_torch_tensor_core_emulation.py``, the global tier's
``tests/test_torch_c12.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.ops import pallas_blindrot as jpb

from eoc_tfhe_tpu_torch.ops import blind_rotate_compact

from torch_emulation import (I32, byte_limbs, emulate_k2_cluster_step, emulate_k2_staged_step,
                             emulate_k2_step)
from torch_reference import reference_scan, rotation_inputs

CASES = {
    "test_params": lambda: jparams.test_params(),
    "toy": lambda: jparams.test_params(n=16, N=64, k=1, l=3, Bgbit=7),
    "full_width_128": lambda: jparams.default_128bit_params(),
}
#: ROADMAP C7: U = 4, N = 2048, fewer samples a block, one key limb a pass.
C7_CASES = {
    "N2048_k1_l3": lambda: jparams.test_params(N=2048, k=1, l=3, Bgbit=7),
    "N1024_k2_l3": lambda: jparams.test_params(N=1024, k=2, l=3, Bgbit=7),
    "N512_k3_l3": lambda: jparams.test_params(N=512, k=3, l=3, Bgbit=6),
    "N1024_k1_l5": lambda: jparams.test_params(N=1024, k=1, l=5, Bgbit=5),
}
#: ROADMAP C8: N = 4096, U = 5 and the row-share plan.
C8_CASES = {
    "N4096_k1_l3": lambda: jparams.test_params(N=4096, k=1, l=3, Bgbit=7),
    "N1024_k3_l5": lambda: jparams.test_params(N=1024, k=3, l=5, Bgbit=5),
    "N512_k4_l3": lambda: jparams.test_params(N=512, k=4, l=3, Bgbit=7),
    "N2048_k3_l3": lambda: jparams.test_params(N=2048, k=3, l=3, Bgbit=7),
}


@pytest.mark.parametrize("case,limbs,n_steps", [
    ("test_params", 4, 16), ("test_params", 3, 16), ("toy", 4, 16),
    ("full_width_128", 4, 2), ("full_width_128", 3, 2)])
def test_k2_emulation_matches_reference(case, limbs, n_steps):
    p = CASES[case]()
    rows, acc0, bara = rotation_inputs(p, n_steps, 3, 22)
    key = blind_rotate_compact.prepare_compact_bk(torch.from_numpy(rows), limbs)
    if limbs == 3:
        assert not byte_limbs(key)[0].any()                   # the low limb the kernel skips
    # the reference's rows scan over the stored (exact or rounded) key
    want = np.asarray(jboot.blind_rotate(jnp.asarray(acc0), jnp.asarray(bara.T),
                                         jnp.asarray(key.numpy()), p, rotation_impl="gather"))
    acc = torch.from_numpy(acc0)
    for i in range(n_steps):
        acc = emulate_k2_step(acc, key[i], torch.from_numpy(bara[i]), p)
    np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("case", ["N2048_k1_l3", "N1024_k2_l3", "N512_k3_l3", "N1024_k1_l5"])
def test_k2_emulation_matches_reference_at_the_c7_shapes(case):
    """K2 at U = 4, N = 2048, fewer samples a block and one key limb a pass,
    against the reference's exact scan."""
    p = C7_CASES[case]()
    rows, acc0, bara, want = reference_scan(p, 2, 3, 25)
    key = blind_rotate_compact.prepare_compact_bk(torch.from_numpy(rows))
    acc = torch.from_numpy(acc0)
    for i in range(2):
        acc = emulate_k2_step(acc, key[i], torch.from_numpy(bara[i]), p)
    np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("case", ["N4096_k1_l3", "N1024_k3_l5", "N512_k4_l3", "N2048_k3_l3"])
def test_k2_emulation_matches_reference_at_the_c8_shapes(case):
    """K2 at N = 4096, k = 4 (U = 5) and under its row-share plan (k = 3 l =
    5 at N = 1024: 10 of 20 rows a pass; k = 3 at N = 2048: 7 of 12), each
    share's sums added into acc before the next, against the reference's
    exact scan."""
    p = C8_CASES[case]()
    tg = p.tgsw_params
    U, N = tg.tlwe_params.k + 1, tg.tlwe_params.N
    rows_a_pass = blind_rotate_compact.kernel_plan(U, N, tg.kpl, tg.halfBg)[2]
    assert rows_a_pass == {"N4096_k1_l3": 6, "N1024_k3_l5": 10, "N512_k4_l3": 15,
                           "N2048_k3_l3": 7}[case]
    rows, acc0, bara, want = reference_scan(p, 2, 2, 27)
    key = blind_rotate_compact.prepare_compact_bk(torch.from_numpy(rows))
    acc = torch.from_numpy(acc0)
    for i in range(2):
        acc = emulate_k2_step(acc, key[i], torch.from_numpy(bara[i]), p, rows_a_pass)
    np.testing.assert_array_equal(acc.numpy(), want)


def test_k2_cluster_emulation_matches_reference_scan():
    """ROADMAP C10: K2's output split at N = 8192 with U = 6 (k = 5 l = 1, a
    cluster of 2 blocks, one digit row a pass, the windows of the key rows)
    gives the reference's exact scan bit for bit, every limb sum inside
    int32; and splitting it over 4 blocks gives the same words."""
    p = jparams.test_params(N=8192, k=5, l=1, Bgbit=7)
    tg = p.tgsw_params
    U, N = tg.tlwe_params.k + 1, tg.tlwe_params.N
    plan = blind_rotate_compact.kernel_plan(U, N, tg.kpl, tg.halfBg)
    assert plan == (1, 1, 1, 2)
    rows, acc0, bara, want = reference_scan(p, 2, 2, 29)
    key = blind_rotate_compact.prepare_compact_bk(torch.from_numpy(rows))
    for cluster in (plan[3], 4):
        acc = torch.from_numpy(acc0)
        for i in range(2):
            acc = emulate_k2_cluster_step(acc, key[i], torch.from_numpy(bara[i]), p, cluster,
                                          plan[2])
        np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("cluster,rows", [(1, 2), (2, 3), (4, 1)])
def test_k2_staged_emulation_matches_reference_scan(cluster, rows):
    """ROADMAP C11: K2's staged tier at N = 1024 k = 2 l = 4 (J = 12) over 1,
    2 and 4 blocks and shares of 2, 3 and 1 digit rows (the plan is an
    argument: at this shape the launcher takes an instantiation) gives the
    reference's exact scan bit for bit, each pass's limb sums inside int32."""
    p = jparams.test_params(N=1024, k=2, l=4, Bgbit=6)
    rows_, acc0, bara, want = reference_scan(p, 2, 2, 32)
    key = blind_rotate_compact.prepare_compact_bk(torch.from_numpy(rows_))
    acc = torch.from_numpy(acc0)
    for i in range(2):
        acc = emulate_k2_staged_step(acc, key[i], torch.from_numpy(bara[i]), p, cluster, rows)
    np.testing.assert_array_equal(acc.numpy(), want)


def test_k2_pass_bound_is_the_reference_chunk_rule():
    """K2 bounds the limb sum per pass, as the reference's fused kernel
    bounds it per chunk (J C halfBg 128 < 2^31 with C = min(128, N),
    ``pallas_blindrot.py:135``): where the whole ring's sum reaches 2^31
    (N = 16384 k = 2 l = 3 Bgbit = 8: 2,415,919,104) the chunk rule holds,
    and the plan takes at most ``max_rows`` = 7 digit rows a pass."""
    p = jparams.test_params(N=16384, k=2, l=3, Bgbit=8)
    tg = p.tgsw_params
    J, N = tg.kpl, tg.tlwe_params.N
    assert J * N * tg.halfBg * 128 == 2_415_919_104
    assert J * jpb.chunk_size_for(N) * tg.halfBg * 128 < I32
    assert blind_rotate_compact.max_rows(N, tg.halfBg) == 7
    plan = blind_rotate_compact.kernel_plan(3, N, J, tg.halfBg)
    assert plan[2] <= 7 and plan[2] * N * tg.halfBg * 128 < I32
