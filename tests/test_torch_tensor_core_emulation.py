"""Limb-by-limb emulations of the tensor-core kernels' arithmetic, against the JAX package.

``csrc/blind_rotate_ntt.cu`` (K1, ``crt_ntt_mma.cuh``) and
``csrc/blind_rotate_compact.cu`` (K2) run only on the card.  Their exactness
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

from eoc_tfhe_tpu_torch.core.numeric import wrap32
from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, ntt, rotate

I32 = 1 << 31

CASES = {
    "test_params": lambda: jparams.test_params(),
    "toy": lambda: jparams.test_params(n=16, N=64, k=1, l=3, Bgbit=7),
    "bgbit10": lambda: jparams.test_params(n=8, N=64, k=1, l=2, Bgbit=10),
    "full_width_128": lambda: jparams.default_128bit_params(),
    "full_width_80": lambda: jparams.default_80bit_params(),
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
    """One MMA: int8 operands, exact products summed (int64, then checked)."""
    assert a.dtype == b.dtype == torch.int8
    return torch.einsum(eq, a.to(torch.int64), b.to(torch.int64))


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


def emulate_k1_step(acc, key_step, bara_i, ctx, params):
    """One CMux step as ``crt_ntt_mma.cuh`` computes it."""
    tg = params.tgsw_params
    B, U, N = acc.shape
    R, F, L = ctx.R, ctx.F, ctx.key_limbs
    dig = _digits(acc, bara_i, tg)
    dig = dig.reshape(B, -1, F, R).transpose(-1, -2).reshape(B, -1, F)   # (B, K, t)
    if tg.halfBg <= 128:
        dplanes = [dig.to(torch.int8)]
    else:
        dplanes = [x.to(torch.int8) for x in ntt.split_bytes(dig)]
    keyp = _key_planes(key_step)
    res = []
    for pi, p in enumerate(ctx.primes):
        Wp = _b_planes(ctx.W_mma[pi])[:, :F, :F]              # (4, t, f)
        c0 = _mma(dplanes[0], Wp[0], "bkt,tf->bkf")
        c1 = _mma(dplanes[0], Wp[1], "bkt,tf->bkf")
        if len(dplanes) == 2:
            c0 = c0 + _mma(dplanes[1], Wp[2], "bkt,tf->bkf")
            c1 = c1 + _mma(dplanes[1], Wp[3], "bkt,tf->bkf")
        dhat = ntt.balanced_mod(_int32_sum(c0 + 256 * _int32_sum(c1)), p)
        lo, hi = (x.to(torch.int8) for x in ntt.split_bytes(dhat))   # (B, K, f)
        Alo, Ahi = keyp[0, pi], keyp[1, pi]                   # (f, K, M)
        eq = "bkf,fkm->bfm"
        c0 = _int32_sum(_mma(lo, Alo, eq))
        c1 = _int32_sum(_mma(hi, Alo, eq) + _mma(lo, Ahi, eq))
        c2 = _int32_sum(_mma(hi, Ahi, eq))
        c16 = int(ntt.balanced_mod(torch.tensor(1 << 16), p))     # 2^16 mod p, ~2^10
        chat = ntt.balanced_mod(_int32_sum(c0 + 256 * c1 + c16 * c2), p)   # (B, f, M)
        clo, chi = (x.to(torch.int8) for x in ntt.split_bytes(chat))
        Vp = _b_planes(ctx.Winv_mma[pi])[:, :F, :F]           # (4, f, t)
        eq = "bfm,ft->bmt"
        c0 = _mma(clo, Vp[0], eq) + _mma(chi, Vp[2], eq)
        c1 = _mma(clo, Vp[1], eq) + _mma(chi, Vp[3], eq)
        res.append(ntt.balanced_mod(_int32_sum(c0 + 256 * _int32_sum(c1)), p))
    p0, p1 = ctx.primes
    q = ntt.balanced_mod(_int32_sum((res[1] - res[0]) * ctx.crt_inv), p1)
    V = _int32_sum(res[0] + q * p0).reshape(B, L, U, R, F)
    upd = sum((V[:, li] << (ctx.key_limb_bits * li)) for li in range(L))
    upd = upd.transpose(-1, -2).reshape(B, U, N)               # acc[u][t*R + r]
    return wrap32(acc.to(torch.int64) + upd)


K1_STEPS = {"full_width_128": 3, "full_width_80": 2}


@pytest.mark.parametrize("case", list(CASES))
def test_k1_emulation_matches_reference_scan(case):
    p = CASES[case]()
    n_steps = K1_STEPS.get(case, min(p.n, 6))
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


def emulate_k2_step(acc, key_step, bara_i, params):
    """One CMux step as ``blind_rotate_compact.cu`` computes it: the Toeplitz
    block of every limb from the byte rows [k reversed | -k reversed]."""
    tg = params.tgsw_params
    B, U, N = acc.shape
    dig = _digits(acc, bara_i, tg)
    assert int(dig.abs().max()) <= 128
    dig = dig.to(torch.int8)                                   # (B, J, N)
    J = dig.shape[1]
    pos, neg = _byte_limbs(key_step), _byte_limbs(-key_step.to(torch.int64))   # (4, J, U, N)
    rev = torch.cat([pos.flip(-1), neg.flip(-1)], dim=-1)     # y = N-1-m | 2N-1-m
    c = torch.arange(N)[:, None]
    r = torch.arange(N)[None, :]
    toeplitz = rev[..., N - 1 - c + r]                         # (4, J, U, c, r)
    upd = torch.zeros((B, U, N), dtype=torch.int64)
    for t in range(4):
        if not (pos[t].any() or neg[t].any()):
            continue                                           # the kernel skips it
        s = _int32_sum(_mma(dig, toeplitz[t], "bjr,jucr->buc"))
        upd = upd + (s << (8 * t))
    return wrap32(acc.to(torch.int64) + upd)


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
