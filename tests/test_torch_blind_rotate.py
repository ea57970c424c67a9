"""The port's NTT context, NTT-domain key and blind rotation against the JAX package.

On the CPU the blind rotation runs its plain version, held bit for bit
against the reference's XLA scan (``ntt.blind_rotate_ntt``) and its Pallas
kernel in interpret mode.  The rotation is exact for any TGSW rows, so the
full-width case uses random rows instead of a 128-bit keygen.  The C5 cases
(ROADMAP) hold the padded key at shapes whose K or M is no multiple of 16,
and the kernels' domain checks; the C7 cases the shapes that the kernels took
only after C7 (N = 2048, k = 3, k = 2 at N = 1024, l = 5), each against the
reference's NAND or its scan and Pallas kernels; the C8 cases the shapes the
kernels took only after C8 (N = 4096, K up to 256, k = 4, K2's wide shapes),
and the C9 cases the reference's rounded-key NTT plans.  The C10 cases are
``tests/test_torch_blind_rotate_c10.py``.  Each NAND is held against one
reference NAND of its shape (``tests/torch_reference.py``), on a keyset of
the port's keygen.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import gates as jgates
from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.ops import ntt as jntt
from eoc_tfhe_tpu.ops import pallas_blindrot as jpb
from eoc_tfhe_tpu.ops import pallas_ntt_blindrot2 as jpnb2

from eoc_tfhe_tpu_torch.core import bootstrap, gates, params
from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1, ntt

from torch_emulation import check_kernel_domains
from torch_reference import (assert_nand_matches, assert_port_nand_matches, keyset_pair,
                             reference_nand, reference_scan, rotation_inputs, to_port)

CASES = {
    "toy": lambda: jparams.test_params(n=16, N=64, k=1, l=3, Bgbit=7),
    "bgbit10": lambda: jparams.test_params(n=8, N=64, k=1, l=2, Bgbit=10),
    "full_width_8_steps": lambda: jparams.default_128bit_params(),
}


def _jctx(p):
    return jpnb2.kernel_context_for_params(p)


def test_prepare_key_ntt_goes_a_chunk_of_steps_at_a_time(monkeypatch):
    """The "ntt_scan" key is built ``ntt.KEY_CHUNK_BYTES`` of residues at a
    time (the whole key at N = 16384 is 15.9 GB, its intermediates several
    times that); chunks of one step give the bytes of one chunk, which are
    the reference's."""
    p = jparams.test_params(n=5)
    rows, _, _ = rotation_inputs(p, 5, 1, seed=97)
    ctx = ntt.context_for_params(p, device="cpu")
    whole = ntt.prepare_key_ntt(torch.from_numpy(rows), ctx)
    jctx = jntt.context_for_params(p)
    np.testing.assert_array_equal(
        whole.numpy(),
        ntt.scan_to_v1_key(torch.from_numpy(np.array(jntt.prepare_key_ntt_np(rows, jctx).T8))))
    monkeypatch.setattr(ntt, "KEY_CHUNK_BYTES", 1)
    assert torch.equal(ntt.prepare_key_ntt(torch.from_numpy(rows), ctx), whole)


@pytest.mark.parametrize("case", list(CASES))
def test_context_matches_reference(case):
    p = CASES[case]()
    ref = _jctx(p)
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    assert (ctx.N, ctx.R, ctx.F, ctx.primes, ctx.key_limbs, ctx.key_limb_bits, ctx.J) == (
        ref.N, ref.R, ref.F, ref.primes, ref.key_limbs, ref.key_limb_bits, ref.J)
    for mine, limbs in ((ctx.W, ref.Wf8), (ctx.Winv, ref.Wi8)):
        limbs = np.asarray(limbs).astype(np.int64)
        np.testing.assert_array_equal(mine.numpy(), limbs[:, 0] + 256 * limbs[:, 1])
    np.testing.assert_array_equal(ctx.omega.numpy(), np.asarray(ref.omega))


@pytest.mark.parametrize("case", list(CASES))
def test_prepared_key_matches_reference(case):
    p = CASES[case]()
    rows, _, _ = rotation_inputs(p, 3, 1, seed=1)
    T8k = jntt.prepare_kernel_key_fast_np(rows, _jctx(p)).astype(np.int64)
    M = T8k.shape[-1] // 2
    key = ntt.prepare_kernel_key(torch.from_numpy(rows),
                                 ntt.kernel_context_for_params(p, device="cpu"))
    assert key.dtype == torch.int8 and key.numel() == 2 * T8k[..., :M].size
    np.testing.assert_array_equal(ntt.unpack_kernel_key(key).numpy(),
                                  T8k[..., :M] + 256 * T8k[..., M:])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_blind_rotation_matches_reference(case):
    p = CASES[case]()
    n_steps = min(p.n, 8)
    B = 3
    rows, acc0, bara, ref_scan = reference_scan(p, n_steps, B, 2)
    jctx = _jctx(p)
    ref_kernel = np.asarray(jpnb2.blind_rotate_ntt_pallas2(
        jnp.asarray(acc0), jnp.asarray(bara), jnp.asarray(jntt.prepare_kernel_key_fast_np(rows, jctx)),
        jctx, p, block_b=B, interpret=True, expanded=False))
    np.testing.assert_array_equal(ref_kernel, ref_scan)

    ctx = ntt.kernel_context_for_params(p, device="cpu")
    key = ntt.prepare_kernel_key(torch.from_numpy(rows), ctx)
    out = blind_rotate.blind_rotate_ntt(torch.from_numpy(acc0), torch.from_numpy(bara),
                                        key, ctx, p)
    np.testing.assert_array_equal(out.numpy(), ref_kernel)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    p = CASES["toy"]()
    rows, acc0, bara = rotation_inputs(p, 4, 2, seed=3)
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    key = ntt.prepare_kernel_key(torch.from_numpy(rows), ctx)
    before = blind_rotate.launches
    out = blind_rotate.blind_rotate_ntt(torch.from_numpy(acc0), torch.from_numpy(bara),
                                        key, ctx, p)
    plain = blind_rotate.blind_rotate_ntt_plain(torch.from_numpy(acc0),
                                                torch.from_numpy(bara), key, ctx, p)
    assert blind_rotate.launches == before
    assert torch.equal(out, plain)
    with pytest.raises(ValueError, match="shape mismatch"):
        blind_rotate.blind_rotate_ntt(torch.from_numpy(acc0), torch.from_numpy(bara[:, :1]),
                                      key, ctx, p)


# --- C5: the padded key and the kernels' domains ------------------------------

C5_CASES = {
    "k2_l2_N64": lambda: jparams.test_params(k=2, l=2, N=64, n=4),     # M = 72, U*R = 24
    "k1_l4_N64": lambda: jparams.test_params(k=1, l=4, N=64),          # K = 64
    "k1_l2_N128": lambda: jparams.test_params(k=1, l=2, N=128),        # F = 16
}


@pytest.mark.parametrize("case", list(C5_CASES))
def test_packed_key_round_trips_with_padding(case):
    p = C5_CASES[case]()
    tg = p.tgsw_params
    rows, _, _ = rotation_inputs(p, 2, 1, seed=5)
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    res = ntt.kernel_key_residues(torch.from_numpy(rows), ctx)
    K, M = tg.kpl * ctx.R, ctx.key_limbs * (tg.tlwe_params.k + 1) * ctx.R
    key = ntt.pack_kernel_key(res)
    assert tuple(key.shape) == (2, 2, ctx.F, ntt.pad16(M) // 16, ntt.pad16(K) // 16, 32, 16)
    assert torch.equal(ntt.unpack_kernel_key(key, K, M), res)
    padded = ntt.unpack_kernel_key(key)
    assert not padded[..., K:, :].any() and not padded[..., :, M:].any()


@pytest.mark.parametrize("case", list(C5_CASES))
def test_plain_rotation_over_the_padded_key_matches_reference_scan(case):
    p = C5_CASES[case]()
    rows, acc0, bara, want = reference_scan(p, min(p.n, 6), 3, 6)
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    key = ntt.prepare_kernel_key(torch.from_numpy(rows), ctx)
    out = blind_rotate.blind_rotate_ntt(torch.from_numpy(acc0), torch.from_numpy(bara),
                                        key, ctx, p)
    np.testing.assert_array_equal(out.numpy(), want)


def test_c5_default_eval_key_at_k2_matches_reference_nand():
    """ROADMAP C5: the default ("auto") eval key at k = 2 (M = 72) used to
    raise in ``pack_kernel_key``; its NAND now has the reference's words."""
    ref = reference_nand(C5_CASES["k2_l2_N64"](), 31)
    ek = bootstrap.prepare_eval_key_ntt(ref.keys.port.cloud, ref.params, kernel="auto")
    assert ek.form == "ntt_kernel" and ek.bk_ntt_kernel.shape[3] == 80 // 16
    assert_nand_matches(gates.nand(to_port(ref.ca), to_port(ref.cb), ek, ref.params), ref.out,
                        ref.keys.port, ref.a, ref.b)


# --- C7: the shapes the reference computes that the card refused --------------

#: ROADMAP C7: the four probe shapes, and the fifth row of its table (halfBg =
#: 512: the compact form stays refused there, C1).
C7_CASES = {
    "N2048_k1_l3": lambda: jparams.test_params(N=2048, k=1, l=3, Bgbit=7, n=4),
    "N1024_k2_l3": lambda: jparams.test_params(N=1024, k=2, l=3, Bgbit=7, n=4),
    "N512_k3_l3": lambda: jparams.test_params(N=512, k=3, l=3, Bgbit=6, n=4),
    "N1024_k1_l5": lambda: jparams.test_params(N=1024, k=1, l=5, Bgbit=5, n=4),
    "N1024_k2_l1_bg10": lambda: jparams.test_params(N=1024, k=2, l=1, Bgbit=10, n=4),
}
#: The C7 shapes whose NAND is held word for word against the reference's.
C7_NAND = ("N2048_k1_l3", "N512_k3_l3")


@pytest.mark.parametrize("kernel", ["auto", False])
@pytest.mark.parametrize("shape", C7_NAND)
def test_c7_nand_matches_reference_word_for_word(shape, kernel):
    """ROADMAP C7: at N = 2048 (F = 256) and at k = 3 (K = 96) the port's NAND
    over both "ntt" forms ("auto": ntt_kernel) has the words, the variance
    rail and the decryption of the shape's one reference NAND, over its
    cheapest exact form (every exact form gives these words)."""
    ref = reference_nand(C7_CASES[shape](), 71)
    assert_port_nand_matches(ref, "ntt_kernel" if kernel == "auto" else "ntt_scan")


def test_c7_k3_shape_at_full_depth_needs_more_gadget_bits():
    """At n = 630 the k = 3 shape's 18 gadget bits (l = 3, Bgbit = 6) exceed
    the gate noise budget in both packages alike, so its full-depth NAND on
    the card runs at Bgbit = 7 (the same kernel plan)."""
    for pkg in (jparams, params):
        with pytest.raises(ValueError, match="gate noise budget exceeded"):
            (jgates if pkg is jparams else gates).check_noise_budget(
                pkg.test_params(N=512, k=3, l=3, Bgbit=6, n=630), -1, -1)
        (jgates if pkg is jparams else gates).check_noise_budget(
            pkg.test_params(N=512, k=3, l=3, Bgbit=7, n=630), -1, -1)
    assert blind_rotate_compact.kernel_plan(4, 512, 12, 64) == (8, 1, 12, 1)


@pytest.mark.parametrize("case", [c for c in C7_CASES if c not in C7_NAND]
                         + ["N2048_k3_l3", "N512_k3_l8_bg4"])
def test_c7_plain_rotations_match_reference_scan_and_kernels(case):
    """ROADMAP C7, the other shapes, and two of C8 (K2's row-share plan at k =
    3, N = 2048, and K = 256 at k = 3 l = 8): the port's rotations over both
    "ntt" keys and the compact key (halfBg <= 128) at n = 2, B = 3 against
    the reference's scan, and the compact one against its Pallas K2 in
    interpret mode."""
    p = {**C7_CASES, **C8_CASES}[case]()
    tg = p.tgsw_params
    rows, acc0, bara, want = reference_scan(p, 2, 3, 74)
    acc, ba, rw = (torch.from_numpy(x) for x in (acc0, bara, rows))
    kctx = ntt.kernel_context_for_params(p, device="cpu")
    np.testing.assert_array_equal(blind_rotate.blind_rotate_ntt(
        acc, ba, ntt.prepare_kernel_key(rw, kctx), kctx, p).numpy(), want)
    ctx = ntt.context_for_params(p, device="cpu")
    np.testing.assert_array_equal(blind_rotate_v1.blind_rotate_ntt_v1(
        acc, ba, ntt.prepare_key_ntt(rw, ctx), ctx, p).numpy(), want)
    if tg.halfBg > 128:                        # C1: the compact form refuses
        with pytest.raises(ValueError, match="halfBg = 512 > 128"):
            blind_rotate_compact.check_kernel_domain(p)
        return
    key = blind_rotate_compact.prepare_compact_bk(rw)
    out = blind_rotate_compact.blind_rotate_compact(acc, ba, key, p)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jpb.blind_rotate_pallas(
        jnp.asarray(acc0), jnp.asarray(bara), jpb.prepare_compact_bk(jnp.asarray(rows)), p,
        interpret=True)))


DOMAIN_SETS = {
    "test_params": lambda: params.test_params(),
    "128-bit": lambda: params.default_128bit_params(),
    "80-bit": lambda: params.default_80bit_params(),
    "k2_l2_N64": lambda: params.test_params(k=2, l=2, N=64, n=4),
    "k1_l4_N64": lambda: params.test_params(k=1, l=4, N=64),
    "k1_l2_N128": lambda: params.test_params(k=1, l=2, N=128),
    "k1_l2_N32": lambda: params.test_params(k=1, l=2, N=32),
    **{case: (lambda f=f: params.test_params(**f)) for case, f in (
        ("N2048_k1_l3", dict(N=2048, k=1, l=3, Bgbit=7)),
        ("N1024_k2_l3", dict(N=1024, k=2, l=3, Bgbit=7)),
        ("N512_k3_l3", dict(N=512, k=3, l=3, Bgbit=6)),
        ("N1024_k1_l5", dict(N=1024, k=1, l=5, Bgbit=5)),
        ("N1024_k2_l1_bg10", dict(N=1024, k=2, l=1, Bgbit=10)))},
}


@pytest.mark.parametrize("case", list(DOMAIN_SETS))
def test_kernel_domains_take_the_shipped_sets_and_the_c5_shapes(case):
    """The shipped sets and the C5 shapes keep the 8-sample instantiations;
    the C7 shapes take the general one, at the samples a block that fit."""
    p = DOMAIN_SETS[case]()
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    kctx, sctx = (ntt.kernel_context_for_params(p, device="cpu"),
                  ntt.context_for_params(p, device="cpu"))
    blind_rotate.check_kernel_domain(U, kctx, tg)
    blind_rotate_v1.check_kernel_domain(U, sctx, tg)
    if tg.halfBg <= 128:           # the compact form's own digit domain (ROADMAP C1)
        blind_rotate_compact.check_kernel_domain(p)
    else:
        with pytest.raises(ValueError, match=r"halfBg = 512 > 128"):
            blind_rotate_compact.check_kernel_domain(p)
    samples, general, cluster = blind_rotate.crt_mma_plan(U, sctx, tg,
                                                          blind_rotate_v1.STAGE_BYTES)
    assert blind_rotate.crt_mma_smem_bytes(
        U, sctx, tg, blind_rotate_v1.STAGE_BYTES, samples) <= blind_rotate.SMEM_PER_BLOCK
    assert general == case.startswith("N") and (samples == 8 or general) and cluster == 1
    K2_PLAN = {"N2048_k1_l3": (4, 1), "N1024_k2_l3": (8, 1), "N512_k3_l3": (8, 1),
               "N1024_k1_l5": (8, 1)}
    assert blind_rotate_compact.kernel_plan(U, tg.tlwe_params.N, tg.kpl, tg.halfBg) == \
        (*K2_PLAN.get(case, (8, 4)), tg.kpl, 1)    # all J digit rows a pass, no cluster


#: K1's plan on the H100 by batch: (samples a cluster, blocks a cluster, key
#: slots, Winv staged) of the narrow tier, or None for the plan without it.
#: An H100 80GB HBM3 holds 7 clusters of 16 blocks and 15 of 8 at once
#: (``cudaOccupancyMaxActiveClusters``).  Clusters of 16
#: come first, then the fewest samples a cluster: B <= 7 is a cluster a
#: sample (one sample leaves room for the inverse's fragments), B = 8 and 9
#: clusters of two samples, and B = 64 would need 8 clusters of 16 or 8
#: samples in a cluster of 8, whose key share does not fit beside their
#: digits: from there the plan without the tier.
H100_CLUSTERS = {16: 7, 8: 15}
NARROW_PLANS = {
    "128": {1: (1, 16, 2, True), 5: (1, 16, 2, True), 8: (2, 16, 4, False),
            9: (2, 16, 4, False), 64: None, 128: None, 1024: None, 8192: None},
    "80": {1: (1, 16, 2, True), 5: (1, 16, 2, True), 8: (2, 16, 4, False),
           9: (2, 16, 4, False), 64: None, 128: None, 1024: None, 8192: None},
}
#: The plan's scratch at B = 8192 without the narrow tier: 1024 blocks of the
#: first prime's residues (8, Mp, F) int16 and the digits (DL, 8, Kp, F + 16).
SCRATCH_8192 = {"128": 1024 * (8 * 48 * 128 * 2 + 8 * 48 * 144),
                "80": 1024 * (8 * 64 * 128 * 2 + 2 * 8 * 32 * 144)}


@pytest.mark.parametrize("B", [1, 5, 8, 9, 64, 128, 1024, 8192])
@pytest.mark.parametrize("bits", ["128", "80"])
def test_k1_plan_takes_the_narrow_tier_at_small_batches(bits, B):
    """K1's plan on the H100: the narrow tier (clusters of 16 blocks; no
    device scratch; its shared memory within the card's) where the groups
    leave most SMs idle and it fits, else the plan without a batch, which B
    = 8192 keeps as (8, False, 1) with its scratch.  A card that schedules
    no cluster of the sizes tried keeps that plan too; K3's plan takes no
    batch."""
    p = params.default_128bit_params() if bits == "128" else params.default_80bit_params()
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    want = NARROW_PLANS[bits][B]
    clusters = lambda C, smem: H100_CLUSTERS.get(C, 132 // C)  # noqa: E731
    plan = blind_rotate.crt_mma_plan(U, ctx, tg, batch=B, sms=132, clusters=clusters)
    narrow = blind_rotate.narrow_plan(B, U, ctx, tg, sms=132, clusters=clusters)
    if want is None:
        assert narrow is None and plan == (8, False, 1) == blind_rotate.crt_mma_plan(U, ctx, tg)
        scratch = blind_rotate.kernel_scratch_bytes(B, U, ctx, tg, 8, 1)
        assert scratch == -(-B // 8) * SCRATCH_8192[bits] // 1024
    else:
        samples, cluster, slots, winv = narrow
        assert narrow == want and plan == (samples, False, cluster)
        assert blind_rotate.kernel_scratch_bytes(B, U, ctx, tg, samples, cluster, True) == 0
        assert blind_rotate.narrow_smem_bytes(U, ctx, tg, samples, cluster, slots,
                                              winv) <= blind_rotate.SMEM_PER_BLOCK
    assert blind_rotate.crt_mma_plan(U, ctx, tg, batch=B, sms=132,
                                     clusters=lambda C, smem: 0) == (8, False, 1)
    sctx = ntt.context_for_params(p, device="cpu")
    assert blind_rotate.crt_mma_plan(U, sctx, tg, blind_rotate_v1.STAGE_BYTES) == (8, False, 1)


@pytest.mark.parametrize("bits,B", [("128", B) for B in range(1, 9)] + [("80", 1), ("80", 8)])
def test_k1_narrow_plan_keeps_the_api_batches_on_16_blocks(bits, B):
    """The API's batches on the H100 keep the narrow tier's plan now that the
    inverse's residues and chat's staging have bytes of their own: B <= 7
    one sample a cluster of 16 with two key slots and Winv staged, B = 8 two
    samples a cluster of 16 with four slots."""
    p = params.default_128bit_params() if bits == "128" else params.default_80bit_params()
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    clusters = lambda C, smem: H100_CLUSTERS.get(C, 132 // C)  # noqa: E731
    want = (1, 16, 2, True) if B <= 7 else (2, 16, 4, False)
    assert blind_rotate.narrow_plan(B, U, ctx, tg, sms=132, clusters=clusters) == want
    assert blind_rotate.narrow_smem_bytes(U, ctx, tg, *want) <= blind_rotate.SMEM_PER_BLOCK


#: Shapes whose narrow plans the exchange test walks: the shipped sets
#: (clusters of 16), N = 512 k = 2 l = 2 (F = 64, clusters of 8) and N = 256
#: (F = 32, clusters of 4).
EXCHANGE_SETS = {
    "128": lambda: params.default_128bit_params(),
    "80": lambda: params.default_80bit_params(),
    "N512_k2_l2": lambda: params.test_params(n=8, N=512, k=2, l=2, Bgbit=8),
    "N256_k1_l3": lambda: params.test_params(n=8, N=256, k=1, l=3, Bgbit=7),
}


@pytest.mark.parametrize("case", list(EXCHANGE_SETS))
def test_k1_narrow_exchange_delivers_the_bytes_each_mbarrier_expects(case):
    """For every plan the narrow tier takes (B up to 128, with the H100's
    cluster occupancy and without it), each block's "acc" and "chat"
    mbarriers are armed for exactly the bytes the cluster's copies bring:
    every sender's pieces (``samples`` slices a block on "acc", one share on
    "chat") tile the receiving buffer without a gap or an overlap, each
    16-byte aligned and a multiple of 16 bytes, as ``cp.async.bulk`` needs."""
    p = EXCHANGE_SETS[case]()
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    plans = {blind_rotate.narrow_plan(B, U, ctx, tg, sms=132, clusters=clusters)
             for B in range(1, 129)
             for clusters in (None, lambda C, smem: H100_CLUSTERS.get(C, 132 // C))}
    plans.discard(None)
    assert len(plans) >= 3, plans
    for samples, cluster, slots, winv in plans:
        ex = blind_rotate.narrow_exchange(U, ctx, samples, cluster)
        for name, per_sender in (("acc", samples), ("chat", 1)):
            armed, pieces = ex[name]
            assert sorted(c for c, _, _ in pieces) == sorted(list(range(cluster)) * per_sender)
            assert sum(n for _, _, n in pieces) == armed
            at = 0
            for _, offset, n in sorted(pieces, key=lambda x: x[1]):
                assert offset == at and offset % 16 == 0 and n % 16 == 0 and n > 0
                at += n
        assert blind_rotate.narrow_smem_bytes(U, ctx, tg, samples, cluster, slots,
                                              winv) <= blind_rotate.SMEM_PER_BLOCK


def test_kernel_domains_refuse_by_name():
    """What stays outside the domains after C11 is refused by name: no
    context (K1 at N >= 4096), l*Bgbit > 32,
    halfBg > 128 for K2 (C1), N < 8, and the rows form where the reference's
    rows scan asserts.  The shapes refused here before C10 and C11 are
    ``test_kernel_domains_take_the_formerly_refused_shapes``."""
    huge = params.test_params(N=4096, k=1, l=3, Bgbit=7)      # F = 512
    with pytest.raises(ValueError, match=r"K1 \(blind_rotate_ntt\) has no context at N=4096: "
                                         r"its prime 32257 .*1024 does not divide 32257-1"):
        ntt.kernel_context_for_params(huge, device="cpu")     # as in the reference
    with pytest.raises(ValueError, match=r"1024 does not divide 32257-1"):
        jpnb2.kernel_context_for_params(huge)
    # the rows form where the reference's rows scan asserts (J*N*halfBg*128)
    rows = params.test_params(N=16384, k=2, l=3, Bgbit=8)
    with pytest.raises(ValueError, match=r"rows eval-key form's int32 sum reaches "
                                         r"2,415,919,104 >= 2\^31"):
        blind_rotate_compact.check_rows_domain(rows)
    blind_rotate_compact.check_kernel_domain(rows)            # the fused form takes it
    with pytest.raises(ValueError, match=r"K2 .* takes N a power of two from 8; got N=4"):
        blind_rotate_compact.check_kernel_domain(params.test_params(N=4, k=1, l=2))
    deep = params.test_params(N=1024, k=1, l=5, Bgbit=7)      # l*Bgbit = 35
    tg = deep.tgsw_params
    with pytest.raises(ValueError, match=r"K3 .* takes Bgbit <= 15 and l\*Bgbit <= 32"):
        blind_rotate_v1.check_kernel_domain(2, ntt.context_for_params(deep, device="cpu"), tg)
    with pytest.raises(ValueError, match=r"K2 .* takes l\*Bgbit <= 32"):
        blind_rotate_compact.check_kernel_domain(deep)
    with pytest.raises(ValueError, match=r"halfBg = 512 > 128"):   # C1 stays refused
        blind_rotate_compact.check_kernel_domain(params.test_params(N=1024, k=2, l=1, Bgbit=10))


#: The shapes ``test_kernel_domains_refuse_by_name`` refused before C10 and
#: C11, now taken: (params, kernel, the plan its launcher picks).
FORMERLY_REFUSED = {
    "K2 N=8192": (lambda: params.test_params(N=8192, k=1, l=2), "K2", (2, 1, 1, 1)),
    "K2 N=16": (lambda: params.test_params(N=16), "K2", (8, 4, 4, 1)),
    "K2 k=5": (lambda: params.test_params(k=5, l=2, N=64), "K2", (8, 4, 12, 1)),
    "K1 K=288": (lambda: params.test_params(N=512, k=3, l=9, Bgbit=3), "K1", (2, True, 1)),
    "K3 K=288": (lambda: params.test_params(N=512, k=3, l=9, Bgbit=3), "K3", (2, True, 1)),
    "K3 240,384 bytes": (lambda: params.test_params(N=4096, k=1, l=9, Bgbit=3), "K3",
                         (1, True, 2)),
    "K2 262,224 bytes": (lambda: params.test_params(N=4096, k=3, l=3, Bgbit=7), "K2",
                         (1, 1, 3, 1)),
    "K2 245,840 bytes": (lambda: params.test_params(N=4096, k=4, l=1, Bgbit=7), "K2",
                         (1, 1, 3, 1)),
    # C11: K3's stream tier, K2's staged tier and K2's limb sum bounded per pass
    "K3 251,136 bytes": (lambda: params.test_params(N=4096, k=2, l=15, Bgbit=2), "K3",
                         (1, True, 2)),
    "K2 237,744 bytes": (lambda: params.test_params(N=16384, k=3, l=2, Bgbit=7), "K2",
                         (1, 1, 1, 4)),
    "K2 limb sum 2,147,483,648": (lambda: params.test_params(N=16384, k=1, l=4, Bgbit=8), "K2",
                                  (1, 1, 1, 4)),
}


@pytest.mark.parametrize("case", list(FORMERLY_REFUSED))
def test_kernel_domains_take_the_formerly_refused_shapes(case):
    """ROADMAP C10: N = 8192 and N = 16 (K2), k = 5 (K2), K = 288 (K1, K3),
    and the shapes whose one sample overflowed a block at 240,384 (K3) and
    262,224 and 245,840 bytes (K2) are in the domains, at the plans the
    launchers pick (the last entry the blocks a cluster); ROADMAP C11: so
    are the shapes refused at 251,136 bytes (K3, now its stream tier),
    237,744 bytes (K2, now its staged tier) and for a limb sum of
    2,147,483,648 (K2, now one digit row a pass)."""
    make, kernel, plan = FORMERLY_REFUSED[case]
    p = make()
    tg = p.tgsw_params
    U, N = tg.tlwe_params.k + 1, tg.tlwe_params.N
    if kernel == "K2":
        blind_rotate_compact.check_kernel_domain(p)
        got = blind_rotate_compact.kernel_plan(U, N, tg.kpl, tg.halfBg)
        assert blind_rotate_compact.smem_bytes(
            U, N, tg.kpl, *got,
            blind_rotate_compact.is_general(U, N, got, case == "K2 237,744 bytes"),
            blind_rotate_compact.is_staged(U, N, tg.kpl, tg.halfBg)) <= \
            blind_rotate.SMEM_PER_BLOCK
        assert blind_rotate_compact.is_staged(U, N, tg.kpl, tg.halfBg) == (
            case == "K2 237,744 bytes")
    elif kernel == "K1":
        ctx = ntt.kernel_context_for_params(p, device="cpu")
        blind_rotate.check_kernel_domain(U, ctx, tg)
        got = blind_rotate.crt_mma_plan(U, ctx, tg)
    else:
        ctx = ntt.context_for_params(p, device="cpu")
        blind_rotate_v1.check_kernel_domain(U, ctx, tg)
        got = blind_rotate.crt_mma_plan(U, ctx, tg, blind_rotate_v1.STAGE_BYTES)
        assert (blind_rotate.crt_mma_stream(U, ctx, tg, blind_rotate_v1.STAGE_BYTES)
                is not None) == (case == "K3 251,136 bytes")
    assert got == plan


# --- C8: the shapes up to N = 4096 and K = 256 that the card refused ----------

#: ROADMAP C8: the three probe shapes (N = 4096, F = 512; k = 3 l = 5, K =
#: 160; k = 4, U = 5), and the shapes of K2's row-share plan and of K = 256.
C8_CASES = {
    "N4096_k1_l3": lambda: jparams.test_params(N=4096, k=1, l=3, Bgbit=7, n=4),
    "N1024_k3_l5": lambda: jparams.test_params(N=1024, k=3, l=5, Bgbit=5, n=4),
    "N512_k4_l3": lambda: jparams.test_params(N=512, k=4, l=3, Bgbit=7, n=4),
    "N2048_k3_l3": lambda: jparams.test_params(N=2048, k=3, l=3, Bgbit=7, n=4),
    "N512_k3_l8_bg4": lambda: jparams.test_params(N=512, k=3, l=8, Bgbit=4, n=4),
}
#: The C8 NANDs held word for word: (shape, the port's form), each shape's
#: against its one reference NAND.
C8_NAND = [("N4096_k1_l3", "ntt_scan"), ("N4096_k1_l3", "compact"),
           ("N1024_k3_l5", "ntt_kernel"), ("N1024_k3_l5", "ntt_scan"),
           ("N1024_k3_l5", "compact"), ("N512_k4_l3", "compact")]


@pytest.mark.parametrize("shape,form", C8_NAND)
def test_c8_nand_matches_reference_word_for_word(shape, form):
    """ROADMAP C8: at N = 4096 (F = 512; the ntt_scan form, K3, and the
    compact form, K2), at k = 3 l = 5 (K = 160; both ntt forms and compact)
    and at k = 4 (U = 5; compact) the port's NAND has the words, the variance
    rail and the decryption of the shape's one reference NAND."""
    assert_port_nand_matches(reference_nand(C8_CASES[shape](), 71), form)


def test_c8_k1_refuses_n4096_as_the_reference_does():
    """At N = 4096 the default ("auto") eval key, the ntt_kernel form, has no
    context over KERNEL_PRIMES in either package; the port names K1 and the
    prime, the reference the root of unity."""
    p = C8_CASES["N4096_k1_l3"]()
    jk, tk = keyset_pair(p, 71)
    with pytest.raises(ValueError, match=r"K1 \(blind_rotate_ntt\) has no context at N=4096"):
        bootstrap.prepare_eval_key_ntt(tk.cloud, p)
    with pytest.raises(ValueError, match=r"1024 does not divide 32257-1"):
        jboot.prepare_eval_key_ntt(jk.cloud, p, kernel=True)


C8_DOMAIN = {
    # shape: (K1 plan or None where K1 has no context, K3 plan, K2 plan)
    "N4096_k1_l3": (None, (1, True, 1), (2, 1, 6, 1)),
    "N1024_k3_l5": ((2, True, 1), (2, True, 1), (4, 1, 10, 1)),
    "N512_k4_l3": ((4, True, 1), (4, True, 1), (8, 1, 15, 1)),
    "N2048_k3_l3": ((1, True, 1), (1, True, 1), (2, 1, 7, 1)),
    "N512_k3_l8_bg4": ((4, True, 1), (4, True, 1), (4, 1, 32, 1)),
}


@pytest.mark.parametrize("case", list(C8_DOMAIN))
def test_kernel_domains_take_the_c8_shapes(case):
    """The C8 shapes are in every domain that has a context there, at the
    plans the launchers pick (each plan's shared memory within the card's)."""
    check_kernel_domains(C8_CASES[case](), *C8_DOMAIN[case])


# --- C9: the reference's rounded-key NTT plans --------------------------------

#: ROADMAP C9: sets where ``choose_rounded_plan`` rounds the key (rb = 2 over
#: both prime pairs at N = 64; at N = 128 over DEFAULT_PRIMES only).
C9_CASES = {
    "n4": lambda: jparams.test_params(n=4),
    "N128_n4": lambda: jparams.test_params(N=128, n=4),
}


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("case", list(C9_CASES))
def test_c9_rounded_nand_matches_reference(case, kernel):
    """ROADMAP C9: ``prepare_eval_key_ntt(rounded=True)`` takes the
    reference's rounded plan of the form's prime pair (its Pallas K1 in
    interpret mode for ``kernel=True``, its scan otherwise): the same key
    rounding, words, variance rail and decryption.  Where the plan rounds
    (rb > 0), the exact plan's variance differs from it; the exact plan
    gives the reference's exact NAND."""
    p, (jk, tk), a, b, ca, cb, ref_exact, _ = reference_nand(C9_CASES[case](), 91)
    jek = jboot.prepare_eval_key_ntt(jk.cloud, p, kernel=kernel, rounded=True)
    ref = jgates.nand(ca, cb, jek, p)
    ek = bootstrap.prepare_eval_key_ntt(tk.cloud, p, kernel=kernel, rounded=True,
                                        small_batch=False)
    assert ek.form == ("ntt_kernel" if kernel else "ntt_scan")
    rb = ek.ntt_ctx.key_round_bits
    assert (rb, ek.ntt_ctx.key_limbs, ek.ntt_ctx.key_limb_bits) == (
        jek.ntt_ctx.key_round_bits, jek.ntt_ctx.key_limbs, jek.ntt_ctx.key_limb_bits)
    assert rb == (0 if case == "N128_n4" and kernel else 2)   # the pairs' plans differ at N=128
    out = gates.nand(to_port(ca), to_port(cb), ek, p)
    assert_nand_matches(out, ref, tk, a, b)
    exact = gates.nand(to_port(ca), to_port(cb),
                       bootstrap.prepare_eval_key_ntt(tk.cloud, p, kernel=kernel), p)
    assert_nand_matches(exact, ref_exact, tk, a, b)
    assert (float(exact.current_variance[0]) != float(out.current_variance[0])) == (rb > 0)


def test_c9_small_batch_is_checked_and_changes_no_bits():
    p, (_, tk), a, b, ca, cb, *_ = reference_nand(C9_CASES["n4"](), 91)
    outs = [gates.nand(to_port(ca), to_port(cb), bootstrap.prepare_eval_key_ntt(
        tk.cloud, p, rounded=True, small_batch=sb), p) for sb in ("auto", True, False)]
    for out in outs[1:]:
        assert torch.equal(out.a, outs[0].a) and torch.equal(out.b, outs[0].b)
    with pytest.raises(ValueError, match="small_batch must be"):
        bootstrap.prepare_eval_key_ntt(tk.cloud, p, small_batch="yes")


def test_c9_config_ntt_rounded_matches_reference():
    """``FrameworkConfig(eval_key_form="ntt_rounded")`` gives the rounded
    plan: on the card's form (the reference's choice on its own
    accelerator, ``kernel=True``) with the reference's rounding, and at
    ``test_params(n=4)`` the reference's config NAND words."""
    from eoc_tfhe_tpu import config as jconfig
    from eoc_tfhe_tpu_torch import config
    p, (jk, tk), a, b, ca, cb, *_ = reference_nand(C9_CASES["n4"](), 91)
    ek = config.FrameworkConfig(param_set="test", eval_key_form="ntt_rounded").prepare_eval_key(
        tk.cloud, p)
    jek = jconfig.FrameworkConfig(param_set="test", eval_key_form="ntt_rounded").prepare_eval_key(
        jk.cloud, p)
    assert ek.form == "ntt_kernel" and ek.ntt_ctx.key_round_bits == 2
    assert jek.ntt_ctx.key_round_bits == 2
    assert ek.ntt_ctx.key_round_bits == jboot.prepare_eval_key_ntt(
        jk.cloud, p, kernel=True, rounded=True).ntt_ctx.key_round_bits
    assert_nand_matches(gates.nand(to_port(ca), to_port(cb), ek, p),
                        jgates.nand(ca, cb, jek, p), tk, a, b)
    exact = config.FrameworkConfig(param_set="test", eval_key_form="ntt").prepare_eval_key(
        tk.cloud, p)
    assert exact.ntt_ctx.key_round_bits == 0


#: (N, k, l, Bgbit, n) of the grid on which the rounded plans are compared.
C9_GRID = [(N, k, l, bg, n) for N in (32, 64, 128, 256, 1024, 2048) for k in (1, 2, 3)
           for l, bg in ((2, 8), (3, 7), (4, 5)) for n in (4, 16, 64)]


def test_key_round_bits_match_reference_on_a_grid():
    """``choose_rounded_plan`` and the limb split it leads to, over both prime
    pairs, on a grid of shapes (some round, most do not), and the contexts'
    ``key_round_bits`` at the 128-bit and 80-bit sets (0: exact)."""
    rounded = 0
    for N, k, l, bg, n in C9_GRID:
        p = params.test_params(N=N, k=k, l=l, Bgbit=bg, n=n)
        tg = p.tgsw_params
        var = float(tg.tlwe_params.alpha_min) ** 2
        for primes in (ntt.DEFAULT_PRIMES, ntt.KERNEL_PRIMES):
            args = (tg.kpl, N, tg.halfBg)
            rb = ntt.choose_rounded_plan(*args, n_steps=n, bk_variance=var, primes=primes)
            assert rb == jntt.choose_rounded_plan(*args, n_steps=n, bk_variance=var,
                                                  primes=primes)
            assert ntt._choose_key_limbs(*args, primes, cover_bits=32 - rb) == \
                jntt._choose_key_limbs(*args, primes, cover_bits=32 - rb)
            rounded += rb > 0
    assert 0 < rounded < 2 * len(C9_GRID)
    for name in ("default_128bit_params", "default_80bit_params"):
        p = getattr(params, name)()
        jp = getattr(jparams, name)()
        for mine, ref in ((ntt.context_for_params(p, True, device="cpu"),
                           jntt.context_for_params(jp, rounded=True)),
                          (ntt.kernel_context_for_params(p, True, device="cpu"),
                           jpnb2.kernel_context_for_params(jp, rounded=True))):
            assert mine.key_round_bits == ref.key_round_bits == 0
            assert (mine.key_limbs, mine.key_limb_bits) == (ref.key_limbs, ref.key_limb_bits)


def test_round_key_matches_reference():
    rng = np.random.default_rng(94)
    bk = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    bk[:4] = [-2**31, 2**31 - 1, -1, 0]
    for rb in range(0, 12):
        np.testing.assert_array_equal(
            ntt.round_key(torch.from_numpy(bk), rb).numpy(), jntt.round_key(bk, rb))


@pytest.mark.parametrize("kernel", [True, False])
def test_c9_rounded_key_matches_reference_key(kernel):
    """The rounded plan's prepared key equals the reference's, byte for byte
    (the residues of the rows rounded to their top 32 - rb bits)."""
    p = C9_CASES["n4"]()
    rows, _, _ = rotation_inputs(p, 2, 1, seed=95)
    if kernel:
        jctx = jpnb2.kernel_context_for_params(p, rounded=True)
        ctx = ntt.kernel_context_for_params(p, True, device="cpu")
        T8k = jntt.prepare_kernel_key_fast_np(rows, jctx).astype(np.int64)
        M = T8k.shape[-1] // 2
        res = ntt.unpack_kernel_key(ntt.prepare_kernel_key(torch.from_numpy(rows), ctx),
                                    T8k.shape[-2], M)
        np.testing.assert_array_equal(res.numpy(), T8k[..., :M] + 256 * T8k[..., M:])
    else:
        jctx = jntt.context_for_params(p, rounded=True)
        ctx = ntt.context_for_params(p, True, device="cpu")
        want = ntt.scan_to_v1_key(torch.from_numpy(np.array(
            jntt.prepare_key_ntt_np(rows, jctx).T8)))
        np.testing.assert_array_equal(ntt.prepare_key_ntt(torch.from_numpy(rows), ctx).numpy(),
                                      want.numpy())
    assert ctx.key_round_bits == jctx.key_round_bits == 2
