"""K1's and K3's tensor-core arithmetic, emulated limb by limb, against the JAX package.

``csrc/blind_rotate_ntt.cu`` (K1) and ``csrc/blind_rotate_ntt_v1.cu`` (K3),
both on ``crt_ntt_mma.cuh``, run only on the card.  Their exactness rests on
the int8 splits they make and on bounds for the int32 sums of each MMA.  The
emulations of ``tests/torch_emulation.py`` repeat that arithmetic in torch
on the CPU (every MMA summed in int64 and asserted to stay inside int32);
here they are held bit for bit against the reference's exact scans, and the
bounds against the launchers'.  K2's emulations are
``tests/test_torch_tensor_core_emulation_k2.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.ops import ntt as jntt

from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_v1, ntt

from torch_emulation import (I32, b_planes, emulate_k1_narrow_step, emulate_k1_step,
                             emulate_k3_cluster_step, emulate_k3_step, emulate_k3_stream_step,
                             v1_loader, v1_stage_offsets)
from torch_reference import reference_scan, rotation_inputs

#: The inputs' seed of the emulations held against the reference's scan: K1's,
#: K3's (either prime pair) and the tiers' draw the same inputs at a shape,
#: so one reference scan a shape serves them all.
SEED = 23

CASES = {
    "test_params": lambda: jparams.test_params(),
    "toy": lambda: jparams.test_params(n=16, N=64, k=1, l=3, Bgbit=7),
    "bgbit10": lambda: jparams.test_params(n=8, N=64, k=1, l=2, Bgbit=10),
    "full_width_128": lambda: jparams.default_128bit_params(),
    "full_width_80": lambda: jparams.default_80bit_params(),
}
#: ROADMAP C5: shapes whose K or M is no multiple of 16, or whose U*R != 16.
C5_CASES = {
    "k2_l2_N64": lambda: jparams.test_params(k=2, l=2, N=64, n=4),     # M = 72, U*R = 24
    "k1_l4_N64": lambda: jparams.test_params(k=1, l=4, N=64),          # K = 64
    "k1_l2_N128": lambda: jparams.test_params(k=1, l=2, N=128),        # F = 16
}
#: ROADMAP C7: shapes that the shipped instantiations do not take, each in the
#: general one (K1/K3: 4 or 8 samples a block, F = 256, Kp up to 96, C2
#: reduced; K2: U = 4, N = 2048, 4 samples, one key limb a pass).
C7_CASES = {
    "N2048_k1_l3": lambda: jparams.test_params(N=2048, k=1, l=3, Bgbit=7),   # F = 256
    "N1024_k2_l3": lambda: jparams.test_params(N=1024, k=2, l=3, Bgbit=7),   # K = 72
    "N512_k3_l3": lambda: jparams.test_params(N=512, k=3, l=3, Bgbit=6),     # K = 96, U = 4
    "N1024_k1_l5": lambda: jparams.test_params(N=1024, k=1, l=5, Bgbit=5),   # K = 80
    "N1024_k2_l1_bg10": lambda: jparams.test_params(N=1024, k=2, l=1, Bgbit=10),   # DL = 2
}
#: ROADMAP C8: shapes only the widened general instantiation takes (F = 512,
#: Kp = 160 and 256, DL = 2 at F = 512; K2 at U = 5, N = 4096 and its
#: row-share plan).  N = 4096 has no K1 context (KERNEL_PRIMES).
C8_CASES = {
    "N4096_k1_l3": lambda: jparams.test_params(N=4096, k=1, l=3, Bgbit=7),   # F = 512
    "N1024_k3_l5": lambda: jparams.test_params(N=1024, k=3, l=5, Bgbit=5),   # Kp = 160
    "N512_k3_l8_bg4": lambda: jparams.test_params(N=512, k=3, l=8, Bgbit=4),  # Kp = 256
    "N4096_k1_l1_bg10": lambda: jparams.test_params(N=4096, k=1, l=1, Bgbit=10),   # DL = 2
}
#: ROADMAP C10: K = 288 (Kp past 256, the general instantiations) and F = 4
#: (N = 16 and 8, the general instantiation's one n8 tile); the cluster shapes
#: have tests of their own below.
C10_CASES = {
    "N1024_k3_l9_bg3": lambda: jparams.test_params(N=1024, k=3, l=9, Bgbit=3),   # Kp = 288
    "N16_k1_l3": lambda: jparams.test_params(N=16, k=1, l=3, Bgbit=7),           # F = 4
    "N8_k1_l2": lambda: jparams.test_params(N=8, k=1, l=2, Bgbit=8),             # F = 4, R = 2
}


# --- K1 and K3: the CRT-NTT stages on int8 limbs ----------------------------


K1_STEPS = {"full_width_128": 3, "full_width_80": 2}
K1_CASES = {**CASES, **{c: C5_CASES[c] for c in ("k2_l2_N64", "k1_l4_N64")}, **C7_CASES,
            **{c: C8_CASES[c] for c in ("N1024_k3_l5", "N512_k3_l8_bg4")}, **C10_CASES}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_emulation_matches_reference_scan(case):
    p = K1_CASES[case]()
    n_steps = K1_STEPS.get(case, 2 if case in {**C7_CASES, **C8_CASES, **C10_CASES}
                           else min(p.n, 6))
    rows, acc0, bara, want = reference_scan(p, n_steps, 3, SEED)
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    key = ntt.prepare_kernel_key(torch.from_numpy(rows), ctx)
    acc = torch.from_numpy(acc0)
    for i in range(n_steps):
        acc = emulate_k1_step(acc, key[i], torch.from_numpy(bara[i]), ctx, p)
    np.testing.assert_array_equal(acc.numpy(), want)
    # and the plain version, which the wrapper runs on CPU tensors, agrees
    np.testing.assert_array_equal(blind_rotate.blind_rotate_ntt_plain(
        torch.from_numpy(acc0), torch.from_numpy(bara), key, ctx, p).numpy(), want)


@pytest.mark.parametrize("case", ["test_params", "full_width_128", "full_width_80"])
def test_k1_matrix_fragments_hold_the_context(case):
    p = CASES[case]()
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    F, FP = ctx.F, max(ctx.F, 32)
    for frags, mats in ((ctx.W_mma, ctx.W), (ctx.Winv_mma, ctx.Winv)):
        assert frags.dtype == torch.int8 and tuple(frags.shape) == (2, FP // 8, FP // 32, 32, 4, 8)
        for pi, prime in enumerate(ctx.primes):
            planes = b_planes(frags[pi]).to(torch.int64)
            full = mats[pi].to(torch.int64)
            assert torch.equal(planes[0, :F, :F] + 256 * planes[1, :F, :F], full)
            assert torch.equal(planes[2, :F, :F] + 256 * planes[3, :F, :F],
                               ntt.balanced_mod(256 * full, prime))
            assert not planes[:, F:].any() and not planes[:, :, F:].any()


K3_STEPS = {"full_width_128": 2, "full_width_80": 2}


@pytest.mark.parametrize("case,primes", [
    (c, pr) for c in list(CASES) + ["k2_l2_N64"] + list(C7_CASES) + list(C8_CASES)
    + list(C10_CASES)
    for pr in ("default", "kernel") if not (c.startswith("N4096") and pr == "kernel")])
def test_k3_emulation_matches_reference_scan(case, primes):
    """K3's arithmetic over its own v1 key, either prime pair: over
    DEFAULT_PRIMES c16 = -16386 (mod 40961), so the plain pointwise sum would
    leave int32; with C2 reduced first every MMA sum stays inside it.  Both
    pairs are held against the one reference scan of the shape's inputs:
    the scan is exact, so its words do not depend on the pair."""
    p = {**CASES, **C5_CASES, **C7_CASES, **C8_CASES, **C10_CASES}[case]()
    tg = p.tgsw_params
    pr = ntt.DEFAULT_PRIMES if primes == "default" else ntt.KERNEL_PRIMES
    n_steps = K3_STEPS.get(case, 2 if case in {**C7_CASES, **C8_CASES, **C10_CASES}
                           else min(p.n, 6))
    rows, acc0, bara, want = reference_scan(p, n_steps, 3, SEED)
    ctx = ntt.make_context(tg.tlwe_params.N, tg.kpl, tg.halfBg, pr, device="cpu")
    key8 = ntt.prepare_key_ntt(torch.from_numpy(rows), ctx)
    acc = torch.from_numpy(acc0)
    for i in range(n_steps):
        acc = emulate_k3_step(acc, key8[i], torch.from_numpy(bara[i]), ctx, p)
    np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("case", ["test_params", "k2_l2_N64", "k1_l4_N64"])
def test_k3_loader_gives_the_packed_fragments(case):
    """The v1 key as K3's loader reads it is K1's packed key of the same
    residues, zero padding included."""
    p = {**CASES, **C5_CASES}[case]()
    tg = p.tgsw_params
    rows, _, _ = rotation_inputs(p, 2, 1, 24)
    ctx = ntt.context_for_params(p, device="cpu")
    res = ntt.kernel_key_residues(torch.from_numpy(rows), ctx)
    K, M = res.shape[-2:]
    assert K == tg.kpl * ctx.R and M == ctx.key_limbs * (tg.tlwe_params.k + 1) * ctx.R
    frags = v1_loader(ntt.split_key_bytes(res)[0], K, M)
    assert torch.equal(frags, ntt.pack_kernel_key(res)[0])
    # no two lanes store one byte; each byte store of the warp touches words
    # in distinct banks, and each 32-bit load hits 32 distinct banks
    store, load = v1_stage_offsets()
    assert store.unique().numel() == store.numel()
    for x in store.T:
        words = (x // 4).unique()
        assert (words % 32).unique().numel() == words.numel()
    for x in load.T:
        assert ((x // 4) % 32).unique().numel() == 32


@pytest.mark.parametrize("case", ["test_params", "full_width_128", "full_width_80"])
def test_pointwise_bound_is_a_function_of_the_primes(case):
    """The launcher's pointwise check, as ``check_crt_mma_domain`` mirrors it:
    over DEFAULT_PRIMES only the C2-reduced sum fits int32 (K3); over
    KERNEL_PRIMES the plain sum fits too (K1)."""
    p = CASES[case]()
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    kctx = ntt.kernel_context_for_params(p, device="cpu")
    sctx = ntt.context_for_params(p, device="cpu")
    blind_rotate.check_kernel_domain(U, kctx, tg)
    blind_rotate_v1.check_kernel_domain(U, kctx, tg)
    blind_rotate_v1.check_kernel_domain(U, sctx, tg)
    with pytest.raises(ValueError, match="pointwise int32 sum"):
        blind_rotate.check_kernel_domain(U, sctx, tg)
    Kp = ntt.pad16(tg.kpl * sctx.R)
    c16 = [abs(int(ntt.balanced_mod(torch.tensor(1 << 16), q))) for q in sctx.primes]
    assert c16 == [16386, 4095]
    assert Kp * 2**14 * (513 + max(c16)) >= 2**31
    assert Kp * 2**14 * 513 + max(c * (q - 1) // 2 for c, q in zip(c16, sctx.primes)) < 2**31


@pytest.mark.parametrize("case", list(C7_CASES))
def test_general_instantiation_keeps_every_sum_in_int32(case):
    """Why the general instantiation reduces C2 (pointwise) and, at F = 256,
    C1 (inverse) first: the worst-case plain sums leave int32 at these
    shapes, the reduced ones do not (the launcher's and
    ``check_crt_mma_domain``'s bounds)."""
    p = C7_CASES[case]()
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    samples, general, cluster = blind_rotate.crt_mma_plan(U, ctx, tg)
    assert general and samples in blind_rotate.SAMPLES and cluster == 1
    Kp, FP = ntt.pad16(tg.kpl * ctx.R), max(ctx.F, 32)
    c16 = max(abs(int(ntt.balanced_mod(torch.tensor(1 << 16), q))) for q in ctx.primes)
    half = max((q - 1) // 2 for q in ctx.primes)
    assert Kp * 2**14 * 513 + c16 * half < I32                 # C2 reduced
    assert (Kp * 2**14 * (513 + c16) >= I32) == (Kp > 80)      # plain: K1 at Kp = 96
    if FP > 128:
        assert 257 * FP * 2**15 >= I32                          # the plain inverse sum
        assert FP * 2**15 + 256 * half < I32                    # C1 reduced
    else:
        assert 257 * FP * 2**15 < I32


# --- C8 and C9: the widened general instantiation and the rounded plans -------

@pytest.mark.parametrize("case", list(C8_CASES))
def test_c8_sums_need_their_reductions(case):
    """Each reduction the general instantiation adds for C8 is needed where
    it applies and enough: at F = 512 the forward's plain sum 257 F 128
    (128 + d_hi) leaves int32 and C1 reduced first keeps it inside; at Kp =
    256 the pointwise C0 + 256 C1 + c16 C2 (C2 reduced) leaves it, and with
    C1 reduced too it stays inside.  ``crt_mma_sums`` (the launcher's bounds)
    stays below 2^31 at every C8 shape over every pair that has a context."""
    p = C8_CASES[case]()
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    ctxs = [ntt.context_for_params(p, device="cpu")]
    if tg.tlwe_params.N < 4096:
        ctxs.append(ntt.kernel_context_for_params(p, device="cpu"))
    for ctx in ctxs:
        Kp, FP = ntt.pad16(tg.kpl * ctx.R), max(ctx.F, 32)
        half = max((q - 1) // 2 for q in ctx.primes)
        c16 = max(abs(int(ntt.balanced_mod(torch.tensor(1 << 16), q))) for q in ctx.primes)
        dhi = 0 if tg.halfBg <= 128 else -(-tg.halfBg // 256)
        for reduce_c2 in (False, True):
            sums = blind_rotate.crt_mma_sums(U, ctx, tg, reduce_c2=reduce_c2)
            assert max(sums.values()) < I32, sums
        assert (257 * FP * 128 * (128 + dhi) >= I32) == (FP > 256)
        assert FP * 128 * (128 + dhi) + 256 * half < I32
        assert (Kp * 2**14 * 513 + c16 * half >= I32) == (Kp > 192)
        assert Kp * 2**14 + 256 * half + c16 * half < I32


@pytest.mark.parametrize("kernel", ["K1", "K3"])
@pytest.mark.parametrize("case", ["n4", "k2_l2_N64", "k2_l3_N64"])
def test_rounded_plans_emulation_matches_reference_scan(case, kernel):
    """ROADMAP C9: K1 and K3 over a rounded plan's key (rb = 2: 2 limbs of 15
    bits; the register path, the scatter path and the general instantiation)
    shift limb l by rb + kbits l, and give the reference's scan over the
    same rounded plan bit for bit."""
    p = {"n4": lambda: jparams.test_params(n=4),
         "k2_l2_N64": lambda: jparams.test_params(k=2, l=2, N=64, n=4),
         "k2_l3_N64": lambda: jparams.test_params(k=2, l=3, N=64, n=4)}[case]()
    tg = p.tgsw_params
    rows, acc0, bara = rotation_inputs(p, 3, 3, 26)
    if kernel == "K1":
        ctx = ntt.kernel_context_for_params(p, rounded=True, device="cpu")
        key = ntt.prepare_kernel_key(torch.from_numpy(rows), ctx)
        step = emulate_k1_step
    else:
        ctx = ntt.context_for_params(p, rounded=True, device="cpu")
        key = ntt.prepare_key_ntt(torch.from_numpy(rows), ctx)
        step = emulate_k3_step
    rb = ctx.key_round_bits
    assert rb == (0 if (case, kernel) == ("k2_l3_N64", "K1") else 2)
    sctx = jntt.make_context(N=tg.tlwe_params.N, J=tg.kpl, halfBg=tg.halfBg,
                             primes=ctx.primes, key_round_bits=rb)
    want = np.asarray(jntt.blind_rotate_ntt(
        jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), p, sctx))
    acc = torch.from_numpy(acc0)
    for i in range(3):
        acc = step(acc, key[i], torch.from_numpy(bara[i]), ctx, p)
    np.testing.assert_array_equal(acc.numpy(), want)


# --- C10: the cluster instantiations ------------------------------------------


@pytest.mark.parametrize("samples", [1, 8])
@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("case", ["full_width_128", "full_width_80"])
def test_k1_narrow_emulation_matches_reference_scan(case, cluster, samples):
    """K1's narrow tier at the shipped sets, split over 8 and 16 blocks (Fc
    = 16, 8), at a batch of 3 in clusters of one sample (the plan's at B <=
    7) and of eight (its from B = 33: three live columns of the pointwise
    MMA, the rest repeating sample 0), gives
    the reference's scan bit for bit with every int32 sum of the shipped
    instantiation inside int32."""
    p = CASES[case]()
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    rows, acc0, bara, want = reference_scan(p, K1_STEPS[case], 3, SEED)
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    assert blind_rotate.crt_mma_plan(U, ctx, tg, batch=3) == (1, False, 16)
    key = ntt.prepare_kernel_key(torch.from_numpy(rows), ctx)
    acc = torch.from_numpy(acc0)
    for i in range(K1_STEPS[case]):
        acc = emulate_k1_narrow_step(acc, key[i], torch.from_numpy(bara[i]), ctx, p, cluster,
                                     samples)
    np.testing.assert_array_equal(acc.numpy(), want)


#: N = 8192 k = 1 l = 3 (F = 1024): K3's plan is a cluster of 2; 4 is the
#: next size the launcher would take.
C10_CLUSTER = {"N8192_k1_l3": lambda: jparams.test_params(N=8192, k=1, l=3, Bgbit=7)}


@pytest.mark.parametrize("cluster", [2, 4])
def test_k3_cluster_emulation_matches_reference_scan(cluster):
    """ROADMAP C10: K3's cluster dataflow at F = 1024, split over 2 and 4
    blocks (each block's dhat and chat of its frequencies, the inverse of
    its columns over every f read from the owning blocks), gives the
    reference's scan bit for bit, with every MMA sum inside int32."""
    p = C10_CLUSTER["N8192_k1_l3"]()
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    rows, acc0, bara, want = reference_scan(p, 2, 2, 28)
    ctx = ntt.context_for_params(p, device="cpu")
    assert blind_rotate.crt_mma_plan(U, ctx, tg, blind_rotate_v1.STAGE_BYTES) == (1, True, 2)
    key8 = ntt.prepare_key_ntt(torch.from_numpy(rows), ctx)
    acc = torch.from_numpy(acc0)
    for i in range(2):
        acc = emulate_k3_cluster_step(acc, key8[i], torch.from_numpy(bara[i]), ctx, p, cluster)
    np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("case", ["N8192_k1_l3", "N16384_k1_l3", "N4096_k2_l6_bg4",
                                  "N1024_k3_l9_bg3"])
def test_c10_sums_need_their_reductions(case):
    """Each reduction of the cluster and general stages is needed where it
    applies and enough: at FP = 1024 and 2048 the forward's plain sum 257 FP
    2^14 and the inverse's 257 FP 2^15 leave int32 and with C1 reduced
    first stay inside (each block's inverse contracts over all F); at Kp =
    288 the pointwise sum with C2 alone reduced leaves it and with C1 too
    stays inside.  ``crt_mma_sums`` (the launcher's bounds) stays below 2^31
    at each shape over every pair with a context."""
    p = {"N8192_k1_l3": lambda: jparams.test_params(N=8192, k=1, l=3, Bgbit=7),
         "N16384_k1_l3": lambda: jparams.test_params(N=16384, k=1, l=3, Bgbit=7),
         "N4096_k2_l6_bg4": lambda: jparams.test_params(N=4096, k=2, l=6, Bgbit=4),
         **C10_CASES}[case]()
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    ctxs = [ntt.context_for_params(p, device="cpu")]
    if tg.tlwe_params.N < 4096:
        ctxs.append(ntt.kernel_context_for_params(p, device="cpu"))
    for ctx in ctxs:
        Kp, FP = ntt.pad16(tg.kpl * ctx.R), max(ctx.F, 32)
        half = max((q - 1) // 2 for q in ctx.primes)
        c16 = max(abs(int(ntt.balanced_mod(torch.tensor(1 << 16), q))) for q in ctx.primes)
        for reduce_c2 in (False, True):
            assert max(blind_rotate.crt_mma_sums(U, ctx, tg, reduce_c2=reduce_c2).values()) < I32
        cluster = blind_rotate.crt_mma_plan(U, ctx, tg, blind_rotate_v1.STAGE_BYTES)[2]
        assert (257 * FP * 2**14 >= I32) == (FP > 256)
        assert (257 * FP * 2**15 >= I32) == (FP > 128)
        assert FP * 2**14 + 256 * half < I32 and FP * 2**15 + 256 * half < I32
        assert (Kp * 2**14 * 513 + c16 * half >= I32) == (Kp > 192)
        assert Kp * 2**14 + 256 * half + c16 * half < I32
        assert (cluster > 1) == (case in ("N8192_k1_l3", "N16384_k1_l3", "N4096_k2_l6_bg4"))


# --- C11: K3's stream tier ----------------------------


@pytest.mark.parametrize("cluster,fs", [(1, 16), (2, 8), (4, 16)])
def test_k3_stream_emulation_matches_reference_scan(cluster, fs):
    """ROADMAP C11: the stream tier's dataflow at N = 1024 (F = 128, four
    k32 slabs) with K = 160, split over 1, 2 and 4 blocks and walked in
    sub-chunks of 8 or 16 frequencies, gives the reference's scan bit for
    bit with every MMA sum inside int32 (the plan is an argument: at this
    shape the launcher takes the general instantiation)."""
    p = jparams.test_params(N=1024, k=3, l=5, Bgbit=5)
    tg = p.tgsw_params
    rows, acc0, bara, want = reference_scan(p, 2, 3, SEED)
    ctx = ntt.context_for_params(p, device="cpu")
    key8 = ntt.prepare_key_ntt(torch.from_numpy(rows), ctx)
    acc = torch.from_numpy(acc0)
    for i in range(2):
        acc = emulate_k3_stream_step(acc, key8[i], torch.from_numpy(bara[i]), ctx, p,
                                     cluster, fs)
    np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("DL", [1, 2])
def test_stream_slabs_give_the_digit_fragments(DL):
    """The stream tier's digit path, byte for byte: ``digit_pass_stream``
    writes digit (plane q, row k, column t) at byte ((t/32 DL + q) Kp + k) 32
    + t%32 of the scratch; ``forward_stream`` copies slab kt with the 16-byte
    halves of row r swapped where bit 2 of r is set, and lane (g, tig) reads
    its A words of m-tile mt at rows r0 = q Kp + 16 mt + g and r0 + 8, bytes
    4 tig and 16 + 4 tig through the swap.  The words read are the digit
    matrix's m16n8k32 fragments, and each of the four loads of a warp hits 32
    distinct banks."""
    Kp, FP = 48, 128
    rng = np.random.default_rng(31 + DL)
    dig = torch.from_numpy(rng.integers(-128, 128, (DL, Kp, FP)).astype(np.int8))
    q, k, t = (x.reshape(-1) for x in torch.meshgrid(
        torch.arange(DL), torch.arange(Kp), torch.arange(FP), indexing="ij"))
    scratch = torch.zeros(DL * Kp * FP, dtype=torch.int8)
    scratch[((t // 32 * DL + q) * Kp + k) * 32 + t % 32] = dig.reshape(-1)
    lane = torch.arange(32)
    g, tig = lane >> 2, lane & 3
    for kt in range(FP // 32):
        src = scratch[kt * DL * Kp * 32:(kt + 1) * DL * Kp * 32].reshape(-1, 16)   # 16-byte words
        x = torch.arange(src.shape[0])
        row = x >> 1
        slab = torch.empty_like(src)
        slab[2 * row + ((x & 1) ^ ((row >> 2) & 1))] = src
        slab = slab.reshape(-1)
        for qq in range(DL):
            for mt in range(Kp // 16):
                r0 = qq * Kp + mt * 16 + g
                sw = ((r0 >> 2) & 1) * 16
                base = r0 * 32 + 4 * tig
                offsets = [base + sw, base + 8 * 32 + sw, base + (16 ^ sw),
                           base + 8 * 32 + (16 ^ sw)]
                tile = dig[qq, mt * 16:mt * 16 + 16, 32 * kt:32 * kt + 32]
                want = [tile[g[:, None], 4 * tig[:, None] + torch.arange(4)],
                        tile[g[:, None] + 8, 4 * tig[:, None] + torch.arange(4)],
                        tile[g[:, None], 16 + 4 * tig[:, None] + torch.arange(4)],
                        tile[g[:, None] + 8, 16 + 4 * tig[:, None] + torch.arange(4)]]
                for off, w in zip(offsets, want):
                    assert torch.equal(slab[off[:, None] + torch.arange(4)], w)
                    assert ((off // 4) % 32).unique().numel() == 32


