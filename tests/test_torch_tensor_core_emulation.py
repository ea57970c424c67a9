"""Limb-by-limb emulations of the tensor-core kernels' arithmetic, against the JAX package.

``csrc/blind_rotate_ntt.cu`` (K1) and ``csrc/blind_rotate_ntt_v1.cu`` (K3),
both on ``crt_ntt_mma.cuh``, and ``csrc/blind_rotate_compact.cu`` (K2) run
only on the card.  Their exactness
rests on the int8 splits they make and on bounds for the int32 sums of each
MMA.  The emulations below repeat that arithmetic in torch on the CPU: the
same byte planes read from the same layouts (the key's and the matrices'
fragment order included), every MMA as an int8 x int8 product summed in
int64 and asserted to stay inside int32, the same combinations and
reductions.  They are held bit for bit against the reference's exact scans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.ops import ntt as jntt
from eoc_tfhe_tpu.ops import pallas_blindrot as jpb

from eoc_tfhe_tpu_torch.core.numeric import wrap32
from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1, ntt, rotate

from torch_reference_ntt import fast_reference_matrices

I32 = 1 << 31

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


def _inputs(p, n_steps, B, seed):
    tg = p.tgsw_params
    N, U = tg.tlwe_params.N, tg.tlwe_params.k + 1
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2**31, 2**31, (n_steps, tg.kpl, U, N), dtype=np.int64).astype(np.int32)
    acc0 = rng.integers(-2**31, 2**31, (B, U, N), dtype=np.int64).astype(np.int32)
    bara = rng.integers(0, 2 * N, (n_steps, B), dtype=np.int64).astype(np.int32)
    return rows, acc0, bara


def _int32_sum(x: torch.Tensor) -> torch.Tensor:
    """An MMA's int32 accumulator: the exact sum must not leave int32."""
    assert int(x.abs().max()) < I32, "an int32 MMA sum overflows"
    return x


def _digits(acc: torch.Tensor, bara_i: torch.Tensor, tg) -> torch.Tensor:
    """The kernels' digit pass: d = X^a acc - acc, offset trick, (B, J, N)."""
    U, N = acc.shape[1:]
    d = wrap32(rotate.mul_by_xai(acc, bara_i[:, None]).to(torch.int64) - acc.to(torch.int64))
    half, mask = 1 << (tg.Bgbit - 1), (1 << tg.Bgbit) - 1
    offset = sum(half << (32 - (p + 1) * tg.Bgbit) for p in range(tg.l))
    du = (d.to(torch.int64) + offset) & 0xFFFFFFFF
    dig = torch.stack([((du >> (32 - (li + 1) * tg.Bgbit)) & mask) - half
                       for li in range(tg.l)], dim=2)          # (B, U, l, N)
    return dig.reshape(acc.shape[0], U * tg.l, N)


def _mma(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """One MMA: int8 operands, exact products summed (then checked).  The
    sums run in float64, exact while every partial sum is an integer below
    2^53 (int8 products over fewer than 2^39 terms), and come back as int64."""
    assert a.dtype == b.dtype == torch.int8
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(torch.int64)


# --- K1: the CRT-NTT stages on int8 limbs --------------------------------------

def _b_planes(frags: torch.Tensor) -> torch.Tensor:
    """Inverse of ``ntt.mma_b_fragments``: (NT, KT, 32, 4, 8) -> (4, KP, NP) int8."""
    NT, KT = frags.shape[:2]
    x = frags.reshape(NT, KT, 8, 4, 4, 2, 4)                 # nt, kt, g, tig, q, half, e
    return x.permute(4, 1, 5, 3, 6, 0, 2).reshape(4, 32 * KT, 8 * NT)


def _key_planes(key_step: torch.Tensor) -> torch.Tensor:
    """(P, F, M/16, K/16, 32, 16) -> (2, P, F, K, M) int8 [lo, hi] of T[f][k][m]."""
    P, F, MT, KT = key_step.shape[:4]
    x = key_step.reshape(P, F, MT, KT, 8, 4, 2, 2, 4)       # P, F, mt, kt, g, tig, q, half, e
    return x.permute(6, 0, 1, 3, 5, 8, 2, 7, 4).reshape(2, P, F, 16 * KT, 16 * MT)


#: K3's staging tile per warp (``V1Key::kPlane``): 16 x 16 bytes a plane + 16.
V1_PLANE = 16 * 16 + 16


def _v1_stage_offsets():
    """Byte offsets in the staging tile of ``V1Key::load``: where lane 16q + r
    stores byte m of its row (column r of plane q), (32, 16), and where lane
    (g, tig) reads its words lo a0, lo a1, hi a0, hi a1, (32, 4)."""
    lane = torch.arange(32)
    store = ((lane >> 4) * V1_PLANE + (lane & 15))[:, None] + 16 * torch.arange(16)[None, :]
    base = (lane >> 2) * 16 + 4 * (lane & 3)
    load = base[:, None] + torch.tensor([0, 128, V1_PLANE, V1_PLANE + 128])[None, :]
    return store, load


def _v1_loader(key8_step: torch.Tensor, K: int, M: int) -> torch.Tensor:
    """``V1Key::load`` of K3, lane by lane, for every tile of one step: the v1
    key (P, F, K, 2M) int8 -> the pointwise A fragments (P, F, Mp/16, Kp/16,
    32, 16).  Lane 16q + r of tile (mt, kt) loads the 16 bytes of plane q
    (lo, hi) in row k = 16kt + r, columns m = 16mt.. (bytes k*2M + q*M + m of
    the frequency's rows, zero where k >= K or m >= M), stores byte m at its
    staging offset, and reads back its four fragment words."""
    P, F = key8_step.shape[:2]
    MT, KT = ntt.pad16(M) // 16, ntt.pad16(K) // 16
    flat = torch.cat([key8_step.reshape(P, F, K * 2 * M),
                      torch.zeros((P, F, 1), dtype=torch.int8)], dim=-1)
    lane = torch.arange(32)
    q, r = (lane >> 4)[:, None], (lane & 15)[:, None]
    k = (16 * torch.arange(KT))[None, :, None, None] + r                  # (1, KT, 32, 1)
    m = (16 * torch.arange(MT))[:, None, None, None] + torch.arange(16)   # (MT, 1, 1, 16)
    src = torch.where((k < K) & (m < M), k * 2 * M + q * M + m, K * 2 * M)   # the zero byte
    store, load = _v1_stage_offsets()
    stage = torch.zeros((P, F, MT, KT, 2 * V1_PLANE), dtype=torch.int8)
    stage[..., store] = flat[:, :, src]                   # (P, F, MT, KT, lane, m)
    return stage[..., load[:, :, None] + torch.arange(4)].reshape(P, F, MT, KT, 32, 16)


def emulate_k1_step(acc, key_step, bara_i, ctx, params):
    """One CMux step as K1 computes it (``crt_ntt_mma.cuh`` over the packed
    key) in the instantiation its launcher picks: the general one reduces C2
    before the c16 product."""
    samples, general, _ = blind_rotate.crt_mma_plan(acc.shape[1], ctx, params.tgsw_params)
    return _emulate_crt_step(acc, _key_planes(key_step), bara_i, ctx, params,
                             reduce_c2=general, samples=samples, general=general)


def emulate_k3_step(acc, key8_step, bara_i, ctx, params):
    """One CMux step as K3 computes it: ``crt_ntt_mma.cuh`` over the v1 key as
    its loader reads it, with C2 reduced before the c16 product."""
    tg = params.tgsw_params
    K, M = tg.kpl * ctx.R, ctx.key_limbs * acc.shape[1] * ctx.R
    keyp = _key_planes(_v1_loader(key8_step, K, M))
    samples, general, _ = blind_rotate.crt_mma_plan(acc.shape[1], ctx, tg,
                                                    blind_rotate_v1.STAGE_BYTES)
    return _emulate_crt_step(acc, keyp, bara_i, ctx, params, reduce_c2=True, samples=samples,
                             general=general)


def _mma_columns(x: torch.Tensor, samples: int) -> torch.Tensor:
    """The pointwise MMA's 8 columns for each block of ``samples`` samples:
    (B, ...) -> (blocks, 8, ...), columns past the block's samples (and past
    a ragged last block's) repeating the block's sample 0, as the kernel's
    lanes past its samples read sample 0."""
    B = x.shape[0]
    nb = -(-B // samples)
    idx = torch.arange(nb * samples).reshape(nb, samples)
    idx = torch.where(idx < B, idx, idx[:, :1])                      # ragged: sample 0
    cols = torch.cat([idx, idx[:, :1].expand(nb, 8 - samples)], dim=1)
    return x[cols]


def _emulate_crt_step(acc, keyp, bara_i, ctx, params, reduce_c2, samples=8, general=False):
    """One CMux step of ``crt_ntt_mma.cuh``; keyp: (2, P, F, Kp, Mp) int8
    [lo, hi] planes of T[f][k][m] as the pointwise stage's A fragments hold
    them.  The digits are zero-padded to Kp rows, as the digit pass does;
    rows m >= M of the inverse are dropped, as the accumulator update does.
    The pointwise stage runs per block of ``samples`` samples on the MMA's 8
    columns (only the block's own are kept); at F >= 256 the inverse reduces
    C1 before its product by 256, as the kernel's wide instantiations do, and
    at F = 512 the forward too; the general instantiation at Kp > 128
    reduces the pointwise C1.  Limb l of the recombination is shifted by rb +
    kbits l (``ctx.key_round_bits``)."""
    tg = params.tgsw_params
    B, U, N = acc.shape
    R, F, L = ctx.R, ctx.F, ctx.key_limbs
    M = L * U * R
    dig = _digits(acc, bara_i, tg)
    dig = dig.reshape(B, -1, F, R).transpose(-1, -2).reshape(B, -1, F)   # (B, K, t)
    dig = torch.nn.functional.pad(dig, (0, 0, 0, keyp.shape[3] - dig.shape[1]))   # (B, Kp, t)
    if tg.halfBg <= 128:
        dplanes = [dig.to(torch.int8)]
    else:
        dplanes = [x.to(torch.int8) for x in ntt.split_bytes(dig)]
    res = []
    for pi, p in enumerate(ctx.primes):
        Wp = _b_planes(ctx.W_mma[pi])[:, :F, :F]              # (4, t, f)
        c0 = _mma(dplanes[0], Wp[0], "bkt,tf->bkf")
        c1 = _mma(dplanes[0], Wp[1], "bkt,tf->bkf")
        if len(dplanes) == 2:
            c0 = c0 + _mma(dplanes[1], Wp[2], "bkt,tf->bkf")
            c1 = c1 + _mma(dplanes[1], Wp[3], "bkt,tf->bkf")
        if F > 256:                       # 257 F 2^14 would leave int32
            c1 = ntt.balanced_mod(_int32_sum(c1), p)
        dhat = ntt.balanced_mod(_int32_sum(c0 + 256 * _int32_sum(c1)), p)
        lo, hi = (x.to(torch.int8) for x in ntt.split_bytes(dhat))   # (B, K, f)
        Alo, Ahi = keyp[0, pi], keyp[1, pi]                   # (f, K, M)
        lo, hi = _mma_columns(lo, samples), _mma_columns(hi, samples)   # (blocks, 8, K, f)
        eq = "nbkf,fkm->nbfm"
        c0 = _int32_sum(_mma(lo, Alo, eq))
        c1 = _int32_sum(_mma(hi, Alo, eq) + _mma(lo, Ahi, eq))
        c2 = _int32_sum(_mma(hi, Ahi, eq))
        c16 = int(ntt.balanced_mod(torch.tensor(1 << 16), p))     # 2^16 mod p
        if reduce_c2:       # K3 (|c16| up to 16386) and the general instantiation (Kp > 80)
            c2 = ntt.balanced_mod(c2, p)
        if general and keyp.shape[3] > 128:   # Kp 2^15 256 would leave int32
            c1 = ntt.balanced_mod(c1, p)
        chat = ntt.balanced_mod(_int32_sum(c0 + 256 * c1 + c16 * c2), p)
        chat = chat[:, :samples].reshape(-1, *chat.shape[2:])[:B]   # (B, f, Mp)
        clo, chi = (x.to(torch.int8) for x in ntt.split_bytes(chat))
        Vp = _b_planes(ctx.Winv_mma[pi])[:, :F, :F]           # (4, f, t)
        eq = "bfm,ft->bmt"
        c0 = _int32_sum(_mma(clo, Vp[0], eq) + _mma(chi, Vp[2], eq))
        c1 = _int32_sum(_mma(clo, Vp[1], eq) + _mma(chi, Vp[3], eq))
        if F > 128:                       # 257 F 2^15 would leave int32
            c1 = ntt.balanced_mod(c1, p)
        res.append(ntt.balanced_mod(_int32_sum(c0 + 256 * c1), p)[:, :M])
    p0, p1 = ctx.primes
    q = ntt.balanced_mod(_int32_sum((res[1] - res[0]) * ctx.crt_inv), p1)
    V = _int32_sum(res[0] + q * p0).reshape(B, L, U, R, F)
    upd = sum((V[:, li] << (ctx.key_round_bits + ctx.key_limb_bits * li)) for li in range(L))
    upd = upd.transpose(-1, -2).reshape(B, U, N)               # acc[u][t*R + r]
    return wrap32(acc.to(torch.int64) + upd)


K1_STEPS = {"full_width_128": 3, "full_width_80": 2}
K1_CASES = {**CASES, **{c: C5_CASES[c] for c in ("k2_l2_N64", "k1_l4_N64")}, **C7_CASES,
            **{c: C8_CASES[c] for c in ("N1024_k3_l5", "N512_k3_l8_bg4")}, **C10_CASES}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_emulation_matches_reference_scan(case):
    p = K1_CASES[case]()
    n_steps = K1_STEPS.get(case, 2 if case in {**C7_CASES, **C8_CASES, **C10_CASES}
                           else min(p.n, 6))
    rows, acc0, bara = _inputs(p, n_steps, 3, seed=21)
    sctx = jntt.context_for_params(p)
    want = np.asarray(jntt.blind_rotate_ntt(
        jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), p, sctx))
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
            planes = _b_planes(frags[pi]).to(torch.int64)
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
    leave int32; with C2 reduced first every MMA sum stays inside it."""
    p = {**CASES, **C5_CASES, **C7_CASES, **C8_CASES, **C10_CASES}[case]()
    tg = p.tgsw_params
    pr = ntt.DEFAULT_PRIMES if primes == "default" else ntt.KERNEL_PRIMES
    n_steps = K3_STEPS.get(case, 2 if case in {**C7_CASES, **C8_CASES, **C10_CASES}
                           else min(p.n, 6))
    rows, acc0, bara = _inputs(p, n_steps, 3, seed=23)
    sctx = jntt.make_context(N=tg.tlwe_params.N, J=tg.kpl, halfBg=tg.halfBg, primes=pr)
    want = np.asarray(jntt.blind_rotate_ntt(
        jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), p, sctx))
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
    rows, _, _ = _inputs(p, 2, 1, seed=24)
    ctx = ntt.context_for_params(p, device="cpu")
    res = ntt.kernel_key_residues(torch.from_numpy(rows), ctx)
    K, M = res.shape[-2:]
    assert K == tg.kpl * ctx.R and M == ctx.key_limbs * (tg.tlwe_params.k + 1) * ctx.R
    frags = _v1_loader(ntt.split_key_bytes(res)[0], K, M)
    assert torch.equal(frags, ntt.pack_kernel_key(res)[0])
    # no two lanes store one byte; each byte store of the warp touches words
    # in distinct banks, and each 32-bit load hits 32 distinct banks
    store, load = _v1_stage_offsets()
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


# --- K2: the direct negacyclic product on byte limbs -------------------------

def _byte_limbs(v: torch.Tensor) -> torch.Tensor:
    """(…) words mod 2^32 -> (4, …) balanced bytes, the kernel's ``limbs``."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    out = []
    for _ in range(4):
        b = ((v + 128) & 255) - 128
        out.append(b)
        v = ((v - b) & 0xFFFFFFFF) >> 8
    return torch.stack(out).to(torch.int8)


def emulate_k2_step(acc, key_step, bara_i, params, rows=None):
    """One CMux step as ``blind_rotate_compact.cu`` computes it: the digits
    once, then the Toeplitz block of every limb from the byte rows [k
    reversed | -k reversed], each limb's int32 sum over (j, r) added into acc
    before the next limb (the same sums whether the kernel converts four
    limbs a pass or one).  ``rows``: the digit rows a pass of the row-share
    plan (all J by default); each share's sums are added into acc in turn."""
    tg = params.tgsw_params
    B, U, N = acc.shape
    dig = _digits(acc, bara_i, tg)
    assert int(dig.abs().max()) <= 128
    dig = dig.to(torch.int8)                                   # (B, J, N)
    J = dig.shape[1]
    rows = J if rows is None else rows
    out = acc.to(torch.int64)
    for j0 in range(0, J, rows):
        share = key_step[j0:j0 + rows]
        pos, neg = _byte_limbs(share), _byte_limbs(-share.to(torch.int64))   # (4, j, U, N)
        rev = torch.cat([pos.flip(-1), neg.flip(-1)], dim=-1)  # y = N-1-m | 2N-1-m
        # The Toeplitz block T[c][r] = rev[N-1-c+r] times the digits, summed
        # over r: a correlation of the byte row with the digits, exact in
        # float64 (|sum| <= J N 128 128 < 2^53); row c of the block is output
        # N-1-c.
        revs, digs = rev.to(torch.float64), dig[:, j0:j0 + rows].to(torch.float64)
        for t in range(4):
            if not (pos[t].any() or neg[t].any()):
                continue                                       # the kernel skips it
            s = torch.zeros((B, U, N), dtype=torch.float64)
            for j in range(share.shape[0]):
                for u in range(U):
                    corr = torch.nn.functional.conv1d(revs[t, j, u][None, None],
                                                      digs[:, j, None])
                    s[:, u] += corr[0, :, :N].flip(-1)
            out = wrap32(out + (_int32_sum(s.to(torch.int64)) << (8 * t)))
    return out


@pytest.mark.parametrize("case,limbs,n_steps", [
    ("test_params", 4, 16), ("test_params", 3, 16), ("toy", 4, 16),
    ("full_width_128", 4, 2), ("full_width_128", 3, 2)])
def test_k2_emulation_matches_reference(case, limbs, n_steps):
    p = CASES[case]()
    rows, acc0, bara = _inputs(p, n_steps, 3, seed=22)
    key = blind_rotate_compact.prepare_compact_bk(torch.from_numpy(rows), limbs)
    if limbs == 3:
        assert not _byte_limbs(key)[0].any()                   # the low limb the kernel skips
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
    rows, acc0, bara = _inputs(p, 2, 3, seed=25)
    sctx = jntt.context_for_params(p)
    want = np.asarray(jntt.blind_rotate_ntt(
        jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), p, sctx))
    key = blind_rotate_compact.prepare_compact_bk(torch.from_numpy(rows))
    acc = torch.from_numpy(acc0)
    for i in range(2):
        acc = emulate_k2_step(acc, key[i], torch.from_numpy(bara[i]), p)
    np.testing.assert_array_equal(acc.numpy(), want)


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
    rows, acc0, bara = _inputs(p, 3, 3, seed=26)
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


@pytest.mark.parametrize("case", ["N4096_k1_l3", "N1024_k3_l5", "N512_k4_l3", "N2048_k3_l3"])
def test_k2_emulation_matches_reference_at_the_c8_shapes(case):
    """K2 at N = 4096, k = 4 (U = 5) and under its row-share plan (k = 3 l =
    5 at N = 1024: 10 of 20 rows a pass; k = 3 at N = 2048: 7 of 12), each
    share's sums added into acc before the next, against the reference's
    exact scan."""
    p = {**C8_CASES,
         "N512_k4_l3": lambda: jparams.test_params(N=512, k=4, l=3, Bgbit=7),
         "N2048_k3_l3": lambda: jparams.test_params(N=2048, k=3, l=3, Bgbit=7)}[case]()
    tg = p.tgsw_params
    U, N = tg.tlwe_params.k + 1, tg.tlwe_params.N
    rows_a_pass = blind_rotate_compact.kernel_plan(U, N, tg.kpl, tg.halfBg)[2]
    assert rows_a_pass == {"N4096_k1_l3": 6, "N1024_k3_l5": 10, "N512_k4_l3": 15,
                           "N2048_k3_l3": 7}[case]
    rows, acc0, bara = _inputs(p, 2, 2, seed=27)
    sctx = jntt.context_for_params(p)
    want = np.asarray(jntt.blind_rotate_ntt(
        jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), p, sctx))
    key = blind_rotate_compact.prepare_compact_bk(torch.from_numpy(rows))
    acc = torch.from_numpy(acc0)
    for i in range(2):
        acc = emulate_k2_step(acc, key[i], torch.from_numpy(bara[i]), p, rows_a_pass)
    np.testing.assert_array_equal(acc.numpy(), want)


# --- C10: the cluster instantiations ------------------------------------------

def emulate_k3_cluster_step(acc, key8_step, bara_i, ctx, params, cluster):
    """One CMux step of K3's cluster instantiation (``rotate_kernel_cluster``
    in ``crt_ntt_mma.cuh``), block by block, one sample a cluster.  Each of
    the ``cluster`` blocks computes the whole sample's digits, dhat and chat
    of its own Fc = F/cluster frequencies (C1 of the forward reduced first,
    C2 and, at Kp > 128, C1 of the pointwise); then, for its own output
    columns t, it contracts over every f, reading k32 tile kt of chat from
    the block that owns frequencies [32 kt, 32 kt + 32) (the DSMEM read),
    with C1 reduced first.  The CRT and the limb sum follow per column."""
    tg = params.tgsw_params
    B, U, N = acc.shape
    R, F, L = ctx.R, ctx.F, ctx.key_limbs
    K, M = tg.kpl * R, L * U * R
    Kp, Fc = ntt.pad16(K), F // cluster
    keyp = _key_planes(_v1_loader(key8_step, K, M))           # (2, P, F, Kp, Mp)
    dig = _digits(acc, bara_i, tg)
    dig = dig.reshape(B, -1, F, R).transpose(-1, -2).reshape(B, -1, F)
    dig = torch.nn.functional.pad(dig, (0, 0, 0, Kp - dig.shape[1]))   # (B, Kp, t)
    dplanes = ([dig.to(torch.int8)] if tg.halfBg <= 128
               else [x.to(torch.int8) for x in ntt.split_bytes(dig)])
    res = []
    for pi, p in enumerate(ctx.primes):
        c16 = int(ntt.balanced_mod(torch.tensor(1 << 16), p))
        Wp = _b_planes(ctx.W_mma[pi])[:, :F, :F]              # (4, t, f)
        Vp = _b_planes(ctx.Winv_mma[pi])[:, :F, :F]           # (4, f, t)
        chats = []
        for c in range(cluster):                              # block c: frequencies fs
            fs = slice(c * Fc, (c + 1) * Fc)
            c0 = _mma(dplanes[0], Wp[0, :, fs], "bkt,tf->bkf")
            c1 = _mma(dplanes[0], Wp[1, :, fs], "bkt,tf->bkf")
            if len(dplanes) == 2:
                c0 = c0 + _mma(dplanes[1], Wp[2, :, fs], "bkt,tf->bkf")
                c1 = c1 + _mma(dplanes[1], Wp[3, :, fs], "bkt,tf->bkf")
            c1 = ntt.balanced_mod(_int32_sum(c1), p)
            dhat = ntt.balanced_mod(_int32_sum(_int32_sum(c0) + 256 * c1), p)
            lo, hi = (x.to(torch.int8) for x in ntt.split_bytes(dhat))    # (B, Kp, Fc)
            Alo, Ahi = keyp[0, pi, fs], keyp[1, pi, fs]                  # (Fc, Kp, Mp)
            eq = "bkf,fkm->bmf"
            c0 = _int32_sum(_mma(lo, Alo, eq))
            c1 = _int32_sum(_mma(hi, Alo, eq) + _mma(lo, Ahi, eq))
            c2 = ntt.balanced_mod(_int32_sum(_mma(hi, Ahi, eq)), p)
            if Kp > 128:
                c1 = ntt.balanced_mod(c1, p)
            chats.append(ntt.balanced_mod(_int32_sum(c0 + 256 * c1 + c16 * c2), p))   # (B, Mp, Fc)
        res.append(_cluster_inverse(chats, Vp, F, cluster, p)[:, :M])
    p0, p1 = ctx.primes
    q = ntt.balanced_mod(_int32_sum((res[1] - res[0]) * ctx.crt_inv), p1)
    V = _int32_sum(res[0] + q * p0).reshape(B, L, U, R, F)
    upd = sum((V[:, li] << (ctx.key_round_bits + ctx.key_limb_bits * li)) for li in range(L))
    return wrap32(acc.to(torch.int64) + upd.transpose(-1, -2).reshape(B, U, N))


def _digits_r_major(accf: torch.Tensor, bara_i: torch.Tensor, tg, R: int) -> torch.Tensor:
    """The narrow tier's digit pass: d = X^a acc - acc from the r-major
    accumulator accf (B, U, R, F), coefficient c = t R + r, each source
    coefficient src = c - a mod 2N read at row src mod R, column src // R
    mod F, negated from column F on; digits (B, J, N) as ``_digits``."""
    B, U, _, F = accf.shape
    N = R * F
    c = torch.arange(N)
    src = (c[None, :] - bara_i[:, None].to(torch.int64)) % (2 * N)        # (B, N)
    st, sr = src // R, src % R
    flat = accf.to(torch.int64).reshape(B, U, R * F)
    v = torch.gather(flat, 2, (sr * F + st % F)[:, None, :].expand(B, U, N))
    v = torch.where((st < F)[:, None, :], v, -v)
    d = wrap32(v - flat[..., (c % R) * F + c // R])
    half, mask = 1 << (tg.Bgbit - 1), (1 << tg.Bgbit) - 1
    offset = sum(half << (32 - (p + 1) * tg.Bgbit) for p in range(tg.l))
    du = (d.to(torch.int64) + offset) & 0xFFFFFFFF
    dig = torch.stack([((du >> (32 - (li + 1) * tg.Bgbit)) & mask) - half
                       for li in range(tg.l)], dim=2)          # (B, U, l, N)
    return dig.reshape(B, U * tg.l, N)


def emulate_k1_narrow_step(acc, key_step, bara_i, ctx, params, cluster, samples):
    """One CMux step of K1's narrow tier (``rotate_kernel_narrow`` in
    ``crt_ntt_mma.cuh``), block by block: ``cluster`` blocks a group of
    ``samples`` samples; block c owns the frequencies [c Fc, (c + 1) Fc), Fc
    = F/cluster, and the pairs (u, r) c P .. c P + P - 1, P = U R / cluster:
    the accumulator's coefficients t R + r of u (its slice, (P, F) a sample)
    and the inverse's rows m = (limb, u, r) of its pairs.  Each block gathers
    the whole accumulator, r-major, from the slices and forms every digit
    from it; its forward over its columns of W and its pointwise product
    over the key share that one bulk copy stages (bytes [(pi F + c Fc) T, (pi
    F + (c + 1) Fc) T) of the step's packed key, T = (Mp/16)(Kp/16)512) keep
    the shipped sums, nothing reduced before the products by 256 and c16;
    each row of its chat goes to the row's owner, which contracts its rows
    over every f, then takes the CRT and the limb sum into its slice."""
    tg = params.tgsw_params
    B, U, N = acc.shape
    R, F, L = ctx.R, ctx.F, ctx.key_limbs
    Kp, Mp = ntt.pad16(tg.kpl * R), ntt.pad16(L * U * R)
    Fc, P = F // cluster, U * R // cluster
    T = (Mp // 16) * (Kp // 16) * 512
    by_pair = acc.reshape(B, U, F, R).transpose(-1, -2).reshape(B, U * R, F)
    slices = [by_pair[:, c * P:(c + 1) * P] for c in range(cluster)]      # (B, P, F)
    accf = torch.cat(slices, dim=1).reshape(B, U, R, F)                   # the gather
    dig = _digits_r_major(accf, bara_i, tg, R)
    dig = dig.reshape(B, -1, F, R).transpose(-1, -2).reshape(B, -1, F)
    dig = torch.nn.functional.pad(dig, (0, 0, 0, Kp - dig.shape[1]))   # (B, Kp, t)
    dplanes = ([dig.to(torch.int8)] if tg.halfBg <= 128
               else [x.to(torch.int8) for x in ntt.split_bytes(dig)])
    flat = key_step.reshape(-1)
    rows = [[li * U * R + c * P + pair for li in range(L) for pair in range(P)]
            for c in range(cluster)]                                  # block c's rows m
    res = []
    for pi, p in enumerate(ctx.primes):
        c16 = int(ntt.balanced_mod(torch.tensor(1 << 16), p))
        Wp = _b_planes(ctx.W_mma[pi])[:, :F, :F]              # (4, t, f)
        Vp = _b_planes(ctx.Winv_mma[pi])[:, :F, :F]           # (4, f, t)
        chats = []
        for c in range(cluster):
            fs = slice(c * Fc, (c + 1) * Fc)
            c0 = _mma(dplanes[0], Wp[0, :, fs], "bkt,tf->bkf")
            c1 = _mma(dplanes[0], Wp[1, :, fs], "bkt,tf->bkf")
            if len(dplanes) == 2:
                c0 = c0 + _mma(dplanes[1], Wp[2, :, fs], "bkt,tf->bkf")
                c1 = c1 + _mma(dplanes[1], Wp[3, :, fs], "bkt,tf->bkf")
            dhat = ntt.balanced_mod(_int32_sum(_int32_sum(c0) + 256 * _int32_sum(c1)), p)
            share = flat[(pi * F + c * Fc) * T:(pi * F + (c + 1) * Fc) * T]   # the bulk copy
            keyp = _key_planes(share.reshape(1, Fc, Mp // 16, Kp // 16, 32, 16))[:, 0]
            eq = "nbkf,fkm->nbmf"
            lo, hi = (_mma_columns(x.to(torch.int8), samples) for x in ntt.split_bytes(dhat))
            c0 = _int32_sum(_mma(lo, keyp[0], eq))
            c1 = _int32_sum(_mma(hi, keyp[0], eq) + _mma(lo, keyp[1], eq))
            c2 = _int32_sum(_mma(hi, keyp[1], eq))
            z = _int32_sum(_int32_sum(c0 + 256 * _int32_sum(c1)) + _int32_sum(c16 * c2))
            chats.append(ntt.balanced_mod(z, p)[:, :samples].reshape(-1, Mp, Fc)[:B])
        out = []
        for c in range(cluster):                              # the rows' owner
            mine = torch.cat([x[:, rows[c]] for x in chats], dim=-1)   # (B, L P, F)
            clo, chi = (x.to(torch.int8) for x in ntt.split_bytes(mine))
            eq = "bjf,ft->bjt"
            c0 = _int32_sum(_mma(clo, Vp[0], eq) + _mma(chi, Vp[2], eq))
            c1 = _int32_sum(_mma(clo, Vp[1], eq) + _mma(chi, Vp[3], eq))
            out.append(ntt.balanced_mod(_int32_sum(c0 + 256 * c1), p))   # (B, L P, t)
        res.append(out)
    p0, p1 = ctx.primes
    own = []
    for c in range(cluster):
        q = ntt.balanced_mod(_int32_sum((res[1][c] - res[0][c]) * ctx.crt_inv), p1)
        V = _int32_sum(res[0][c] + q * p0).reshape(B, L, P, F)
        upd = sum((V[:, li] << (ctx.key_limb_bits * li)) for li in range(L))
        own.append(wrap32(slices[c].to(torch.int64) + upd))
    return torch.cat(own, dim=1).reshape(B, U, R, F).transpose(-1, -2).reshape(B, U, N)


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
    rows, acc0, bara = _inputs(p, K1_STEPS[case], 3, seed=31)
    sctx = jntt.context_for_params(p)
    want = np.asarray(jntt.blind_rotate_ntt(
        jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), p, sctx))
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
    rows, acc0, bara = _inputs(p, 2, 2, seed=28)
    with fast_reference_matrices():
        sctx = jntt.context_for_params(p)
        want = np.asarray(jntt.blind_rotate_ntt(
            jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), p, sctx))
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


def emulate_k2_cluster_step(acc, key_step, bara_i, params, cluster, rows):
    """One CMux step of K2's general kernel in a cluster of ``cluster``
    blocks: block c owns output coefficients [c Ns, (c+1) Ns) of every
    polynomial (Ns = N/cluster), computes the whole sample's digits from the
    whole accumulators (its own share and the others' read through DSMEM)
    and holds of each byte row [k reversed | -k reversed] only the window
    y in [N - c Ns - Ns, 2N - c Ns) its outputs meet; output c' of limb t
    is sum_r window[N - 1 - c' + r] d[r] over the ``rows`` digit rows of a
    pass, an int32 sum, added into the block's share shifted by 8t.  (The
    correlation runs as a float64 FFT, rounded: every sum is an integer
    below 2^27, which the FFT holds within 0.25.)"""
    tg = params.tgsw_params
    B, U, N = acc.shape
    dig = _digits(acc, bara_i, tg).to(torch.float64)            # (B, J, N), whole samples
    J, Ns = dig.shape[1], N // cluster
    pos, neg = _byte_limbs(key_step), _byte_limbs(-key_step.to(torch.int64))   # (4, J, U, N)
    rev = torch.cat([pos.flip(-1), neg.flip(-1)], dim=-1).to(torch.float64)     # (4, J, U, 2N)
    size = 1 << (N + Ns - 1).bit_length()
    dhat = torch.fft.rfft(dig, size).conj()[:, None, :, None]     # (B, 1, J, 1, .)
    out = acc.to(torch.int64)
    for c in range(cluster):
        y0 = N - c * Ns - Ns
        win = rev[..., y0:y0 + N + Ns]                           # the block's bytes of each row
        corr = torch.fft.irfft(torch.fft.rfft(win, size)[None] * dhat, size)[..., :Ns]
        assert float((corr - corr.round()).abs().max()) < 0.25
        # output c0 + o reads window[Ns - 1 - o + r]: lag Ns - 1 - o
        s = corr.round().to(torch.int64).flip(-1)                 # (B, 4, J, U, Ns)
        for j0 in range(0, J, rows):
            part = _int32_sum(s[:, :, j0:j0 + rows].sum(2))       # (B, 4, U, Ns)
            upd = sum(part[:, t] << (8 * t) for t in range(4))
            out[..., c * Ns:(c + 1) * Ns] = wrap32(out[..., c * Ns:(c + 1) * Ns] + upd)
    return out


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
    rows, acc0, bara = _inputs(p, 2, 2, seed=29)
    with fast_reference_matrices():
        sctx = jntt.context_for_params(p)
        want = np.asarray(jntt.blind_rotate_ntt(
            jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), p, sctx))
    key = blind_rotate_compact.prepare_compact_bk(torch.from_numpy(rows))
    for cluster in (plan[3], 4):
        acc = torch.from_numpy(acc0)
        for i in range(2):
            acc = emulate_k2_cluster_step(acc, key[i], torch.from_numpy(bara[i]), p, cluster,
                                          plan[2])
        np.testing.assert_array_equal(acc.numpy(), want)


# --- C11: K3's and K1's stream tier, K2's staged tier ----------------------------

def emulate_k3_stream_step(acc, key8_step, bara_i, ctx, params, cluster, fs):
    """One CMux step of the stream tier (``rotate_kernel_stream`` in
    ``crt_ntt_mma.cuh``), block by block, one sample a cluster, at the plan
    (``cluster`` blocks, ``fs`` frequencies a sub-chunk) given.  The digits
    are the whole sample's, once a step; each block walks its Fc = F/cluster
    frequencies in sub-chunks of fs: the forward of every k row at those
    frequencies as int32 sums carried across the k32 slabs of t, asserted
    inside int32 after every slab (C1 reduced before its product by 256),
    then the pointwise product over the whole Kp of each frequency at once
    (C2 reduced, and C1 at Kp > 128), giving that sub-chunk's chat.  The
    inverse reads k32 tile kt of chat from the block that owns it, as in
    the cluster instantiation."""
    tg = params.tgsw_params
    B, U, N = acc.shape
    R, F, L = ctx.R, ctx.F, ctx.key_limbs
    K, M = tg.kpl * R, L * U * R
    Kp, Fc = ntt.pad16(K), F // cluster
    keyp = _key_planes(_v1_loader(key8_step, K, M))           # (2, P, F, Kp, Mp)
    dig = _digits(acc, bara_i, tg)
    dig = dig.reshape(B, -1, F, R).transpose(-1, -2).reshape(B, -1, F)
    dig = torch.nn.functional.pad(dig, (0, 0, 0, Kp - dig.shape[1]))   # (B, Kp, t)
    dplanes = ([dig.to(torch.int8)] if tg.halfBg <= 128
               else [x.to(torch.int8) for x in ntt.split_bytes(dig)])
    res = []
    for pi, p in enumerate(ctx.primes):
        c16 = int(ntt.balanced_mod(torch.tensor(1 << 16), p))
        Wp = _b_planes(ctx.W_mma[pi])[:, :F, :F]              # (4, t, f)
        Vp = _b_planes(ctx.Winv_mma[pi])[:, :F, :F]           # (4, f, t)
        chats = []
        for c in range(cluster):
            chat = torch.empty((B, ntt.pad16(M), Fc), dtype=torch.int64)
            for f0 in range(c * Fc, (c + 1) * Fc, fs):        # a sub-chunk
                sub = slice(f0, f0 + fs)
                c0 = c1 = 0
                for kt in range(F // 32):                     # slab kt: t in [32 kt, 32 kt + 32)
                    ts = slice(32 * kt, 32 * kt + 32)
                    c0 = c0 + _mma(dplanes[0][..., ts], Wp[0, ts, sub], "bkt,tf->bkf")
                    c1 = c1 + _mma(dplanes[0][..., ts], Wp[1, ts, sub], "bkt,tf->bkf")
                    if len(dplanes) == 2:
                        c0 = c0 + _mma(dplanes[1][..., ts], Wp[2, ts, sub], "bkt,tf->bkf")
                        c1 = c1 + _mma(dplanes[1][..., ts], Wp[3, ts, sub], "bkt,tf->bkf")
                    _int32_sum(c0), _int32_sum(c1)            # the registers across slabs
                dhat = ntt.balanced_mod(_int32_sum(c0 + 256 * ntt.balanced_mod(c1, p)), p)
                lo, hi = (x.to(torch.int8) for x in ntt.split_bytes(dhat))   # (B, Kp, fs)
                Alo, Ahi = keyp[0, pi, sub], keyp[1, pi, sub]
                eq = "bkf,fkm->bmf"
                d0 = _int32_sum(_mma(lo, Alo, eq))
                d1 = _int32_sum(_mma(hi, Alo, eq) + _mma(lo, Ahi, eq))
                d2 = ntt.balanced_mod(_int32_sum(_mma(hi, Ahi, eq)), p)
                if Kp > 128:
                    d1 = ntt.balanced_mod(d1, p)
                chat[..., f0 - c * Fc:f0 - c * Fc + fs] = ntt.balanced_mod(
                    _int32_sum(d0 + 256 * d1 + c16 * d2), p)
            chats.append(chat)
        res.append(_cluster_inverse(chats, Vp, F, cluster, p)[:, :M])
    p0, p1 = ctx.primes
    q = ntt.balanced_mod(_int32_sum((res[1] - res[0]) * ctx.crt_inv), p1)
    V = _int32_sum(res[0] + q * p0).reshape(B, L, U, R, F)
    upd = sum((V[:, li] << (ctx.key_round_bits + ctx.key_limb_bits * li)) for li in range(L))
    return wrap32(acc.to(torch.int64) + upd.transpose(-1, -2).reshape(B, U, N))


def _cluster_inverse(chats, Vp, F, cluster, p):
    """The cluster inverse: block c's columns t contract over every f, k32
    tile kt of chat read from the block that owns frequencies [32 kt, 32 kt
    + 32), C1 reduced first."""
    Fc = F // cluster
    out = torch.empty((chats[0].shape[0], chats[0].shape[1], F), dtype=torch.int64)
    tiles = [chats[32 * kt // Fc][..., 32 * kt % Fc:32 * kt % Fc + 32] for kt in range(F // 32)]
    clo, chi = (x.to(torch.int8) for x in ntt.split_bytes(torch.cat(tiles, dim=-1)))
    for c in range(cluster):
        ts = slice(c * Fc, (c + 1) * Fc)
        eq = "bmf,ft->bmt"
        c0 = _int32_sum(_mma(clo, Vp[0, :, ts], eq) + _mma(chi, Vp[2, :, ts], eq))
        c1 = ntt.balanced_mod(
            _int32_sum(_mma(clo, Vp[1, :, ts], eq) + _mma(chi, Vp[3, :, ts], eq)), p)
        out[..., ts] = ntt.balanced_mod(_int32_sum(c0 + 256 * c1), p)
    return out


@pytest.mark.parametrize("cluster,fs", [(1, 16), (2, 8), (4, 16)])
def test_k3_stream_emulation_matches_reference_scan(cluster, fs):
    """ROADMAP C11: the stream tier's dataflow at N = 1024 (F = 128, four
    k32 slabs) with K = 160, split over 1, 2 and 4 blocks and walked in
    sub-chunks of 8 or 16 frequencies, gives the reference's scan bit for
    bit with every MMA sum inside int32 (the plan is an argument: at this
    shape the launcher takes the general instantiation)."""
    p = jparams.test_params(N=1024, k=3, l=5, Bgbit=5)
    tg = p.tgsw_params
    rows, acc0, bara = _inputs(p, 2, 2, seed=30)
    sctx = jntt.context_for_params(p)
    want = np.asarray(jntt.blind_rotate_ntt(
        jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), p, sctx))
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


def emulate_k2_staged_step(acc, key_step, bara_i, params, cluster, rows):
    """One CMux step of K2's staged tier, block by block: block c owns
    outputs [c Ns, (c+1) Ns) (Ns = N/cluster); the ``rows`` digit rows of
    each share are computed from the step's accumulators (acc is not
    touched until the commit), and each limb pass adds its int32 sums over
    the share's rows and all N coefficients (asserted inside int32) into
    the block's update buffer; after the last share the buffer is added
    into acc (mod 2^32)."""
    tg = params.tgsw_params
    B, U, N = acc.shape
    J, Ns = tg.kpl, N // cluster
    pos, neg = _byte_limbs(key_step), _byte_limbs(-key_step.to(torch.int64))   # (4, J, U, N)
    rev = torch.cat([pos.flip(-1), neg.flip(-1)], dim=-1).to(torch.float64)     # (4, J, U, 2N)
    size = 1 << (N + Ns - 1).bit_length()
    upd = torch.zeros((B, U, N), dtype=torch.int64)
    for j0 in range(0, J, rows):
        share = _digits(acc, bara_i, tg)[:, j0:j0 + rows].to(torch.float64)   # from acc
        dhat = torch.fft.rfft(share, size).conj()[:, None, :, None]
        for c in range(cluster):
            y0 = N - c * Ns - Ns
            win = rev[:, j0:j0 + rows, :, y0:y0 + N + Ns]
            corr = torch.fft.irfft(torch.fft.rfft(win, size)[None] * dhat, size)[..., :Ns]
            assert float((corr - corr.round()).abs().max()) < 0.25
            s = corr.round().to(torch.int64).flip(-1).sum(2)         # (B, 4, U, Ns)
            for t in range(4):                                       # a limb pass
                upd[..., c * Ns:(c + 1) * Ns] = wrap32(
                    upd[..., c * Ns:(c + 1) * Ns] + (_int32_sum(s[:, t]) << (8 * t)))
    return wrap32(acc.to(torch.int64) + upd)


@pytest.mark.parametrize("cluster,rows", [(1, 2), (2, 3), (4, 1)])
def test_k2_staged_emulation_matches_reference_scan(cluster, rows):
    """ROADMAP C11: K2's staged tier at N = 1024 k = 2 l = 4 (J = 12) over 1,
    2 and 4 blocks and shares of 2, 3 and 1 digit rows (the plan is an
    argument: at this shape the launcher takes an instantiation) gives the
    reference's exact scan bit for bit, each pass's limb sums inside int32."""
    p = jparams.test_params(N=1024, k=2, l=4, Bgbit=6)
    rows_, acc0, bara = _inputs(p, 2, 2, seed=32)
    sctx = jntt.context_for_params(p)
    want = np.asarray(jntt.blind_rotate_ntt(
        jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows_, sctx), p, sctx))
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
