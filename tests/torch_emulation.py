"""Limb-by-limb emulations of the tensor-core kernels' arithmetic, for the port's tests.

``csrc/blind_rotate_ntt.cu`` (K1) and ``csrc/blind_rotate_ntt_v1.cu`` (K3),
both on ``crt_ntt_mma.cuh``, and ``csrc/blind_rotate_compact.cu`` (K2) run
only on the card.  Their exactness rests on the int8 splits they make and
on bounds for the int32 sums of each MMA.  The emulations below repeat that
arithmetic in torch on the CPU: the same byte planes read from the same
layouts (the key's and the matrices' fragment order included), every MMA as
an int8 x int8 product summed in int64 and asserted to stay inside int32,
the same combinations and reductions.  The tests hold them bit for bit
against the reference's exact scans
(``tests/test_torch_tensor_core_emulation.py`` for K1 and K3,
``tests/test_torch_tensor_core_emulation_k2.py`` for K2,
``tests/test_torch_c12.py`` for K2's global tier).  This module imports
neither JAX nor the reference; :func:`check_kernel_domains` is the plan
check the shape tests share.
"""

import pytest
import torch

from eoc_tfhe_tpu_torch.core.numeric import wrap32
from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1, ntt, rotate

I32 = 1 << 31


def int32_sum(x: torch.Tensor) -> torch.Tensor:
    """An MMA's int32 accumulator: the exact sum must not leave int32."""
    assert int(x.abs().max()) < I32, "an int32 MMA sum overflows"
    return x


def cmux_digits(acc: torch.Tensor, bara_i: torch.Tensor, tg) -> torch.Tensor:
    """The kernels' digit pass: d = X^a acc - acc, offset trick, (B, J, N)."""
    U, N = acc.shape[1:]
    d = wrap32(rotate.mul_by_xai(acc, bara_i[:, None]).to(torch.int64) - acc.to(torch.int64))
    half, mask = 1 << (tg.Bgbit - 1), (1 << tg.Bgbit) - 1
    offset = sum(half << (32 - (p + 1) * tg.Bgbit) for p in range(tg.l))
    du = (d.to(torch.int64) + offset) & 0xFFFFFFFF
    dig = torch.stack([((du >> (32 - (li + 1) * tg.Bgbit)) & mask) - half
                       for li in range(tg.l)], dim=2)          # (B, U, l, N)
    return dig.reshape(acc.shape[0], U * tg.l, N)


def mma(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """One MMA: int8 operands, exact products summed (then checked).  The
    sums run in float64, exact while every partial sum is an integer below
    2^53 (int8 products over fewer than 2^39 terms), and come back as int64."""
    assert a.dtype == b.dtype == torch.int8
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(torch.int64)


# --- K1: the CRT-NTT stages on int8 limbs --------------------------------------

def b_planes(frags: torch.Tensor) -> torch.Tensor:
    """Inverse of ``ntt.mma_b_fragments``: (NT, KT, 32, 4, 8) -> (4, KP, NP) int8."""
    NT, KT = frags.shape[:2]
    x = frags.reshape(NT, KT, 8, 4, 4, 2, 4)                 # nt, kt, g, tig, q, half, e
    return x.permute(4, 1, 5, 3, 6, 0, 2).reshape(4, 32 * KT, 8 * NT)


def key_planes(key_step: torch.Tensor) -> torch.Tensor:
    """(P, F, M/16, K/16, 32, 16) -> (2, P, F, K, M) int8 [lo, hi] of T[f][k][m]."""
    P, F, MT, KT = key_step.shape[:4]
    x = key_step.reshape(P, F, MT, KT, 8, 4, 2, 2, 4)       # P, F, mt, kt, g, tig, q, half, e
    return x.permute(6, 0, 1, 3, 5, 8, 2, 7, 4).reshape(2, P, F, 16 * KT, 16 * MT)


#: K3's staging tile per warp (``V1Key::kPlane``): 16 x 16 bytes a plane + 16.
V1_PLANE = 16 * 16 + 16


def v1_stage_offsets():
    """Byte offsets in the staging tile of ``V1Key::load``: where lane 16q + r
    stores byte m of its row (column r of plane q), (32, 16), and where lane
    (g, tig) reads its words lo a0, lo a1, hi a0, hi a1, (32, 4)."""
    lane = torch.arange(32)
    store = ((lane >> 4) * V1_PLANE + (lane & 15))[:, None] + 16 * torch.arange(16)[None, :]
    base = (lane >> 2) * 16 + 4 * (lane & 3)
    load = base[:, None] + torch.tensor([0, 128, V1_PLANE, V1_PLANE + 128])[None, :]
    return store, load


def v1_loader(key8_step: torch.Tensor, K: int, M: int) -> torch.Tensor:
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
    store, load = v1_stage_offsets()
    stage = torch.zeros((P, F, MT, KT, 2 * V1_PLANE), dtype=torch.int8)
    stage[..., store] = flat[:, :, src]                   # (P, F, MT, KT, lane, m)
    return stage[..., load[:, :, None] + torch.arange(4)].reshape(P, F, MT, KT, 32, 16)


def emulate_k1_step(acc, key_step, bara_i, ctx, params):
    """One CMux step as K1 computes it (``crt_ntt_mma.cuh`` over the packed
    key) in the instantiation its launcher picks: the general one reduces C2
    before the c16 product."""
    samples, general, _ = blind_rotate.crt_mma_plan(acc.shape[1], ctx, params.tgsw_params)
    return _emulate_crt_step(acc, key_planes(key_step), bara_i, ctx, params,
                             reduce_c2=general, samples=samples, general=general)


def emulate_k3_step(acc, key8_step, bara_i, ctx, params):
    """One CMux step as K3 computes it: ``crt_ntt_mma.cuh`` over the v1 key as
    its loader reads it, with C2 reduced before the c16 product."""
    tg = params.tgsw_params
    K, M = tg.kpl * ctx.R, ctx.key_limbs * acc.shape[1] * ctx.R
    keyp = key_planes(v1_loader(key8_step, K, M))
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
    dig = cmux_digits(acc, bara_i, tg)
    dig = dig.reshape(B, -1, F, R).transpose(-1, -2).reshape(B, -1, F)   # (B, K, t)
    dig = torch.nn.functional.pad(dig, (0, 0, 0, keyp.shape[3] - dig.shape[1]))   # (B, Kp, t)
    if tg.halfBg <= 128:
        dplanes = [dig.to(torch.int8)]
    else:
        dplanes = [x.to(torch.int8) for x in ntt.split_bytes(dig)]
    res = []
    for pi, p in enumerate(ctx.primes):
        Wp = b_planes(ctx.W_mma[pi])[:, :F, :F]              # (4, t, f)
        c0 = mma(dplanes[0], Wp[0], "bkt,tf->bkf")
        c1 = mma(dplanes[0], Wp[1], "bkt,tf->bkf")
        if len(dplanes) == 2:
            c0 = c0 + mma(dplanes[1], Wp[2], "bkt,tf->bkf")
            c1 = c1 + mma(dplanes[1], Wp[3], "bkt,tf->bkf")
        if F > 256:                       # 257 F 2^14 would leave int32
            c1 = ntt.balanced_mod(int32_sum(c1), p)
        dhat = ntt.balanced_mod(int32_sum(c0 + 256 * int32_sum(c1)), p)
        lo, hi = (x.to(torch.int8) for x in ntt.split_bytes(dhat))   # (B, K, f)
        Alo, Ahi = keyp[0, pi], keyp[1, pi]                   # (f, K, M)
        lo, hi = _mma_columns(lo, samples), _mma_columns(hi, samples)   # (blocks, 8, K, f)
        eq = "nbkf,fkm->nbfm"
        c0 = int32_sum(mma(lo, Alo, eq))
        c1 = int32_sum(mma(hi, Alo, eq) + mma(lo, Ahi, eq))
        c2 = int32_sum(mma(hi, Ahi, eq))
        c16 = int(ntt.balanced_mod(torch.tensor(1 << 16), p))     # 2^16 mod p
        if reduce_c2:       # K3 (|c16| up to 16386) and the general instantiation (Kp > 80)
            c2 = ntt.balanced_mod(c2, p)
        if general and keyp.shape[3] > 128:   # Kp 2^15 256 would leave int32
            c1 = ntt.balanced_mod(c1, p)
        chat = ntt.balanced_mod(int32_sum(c0 + 256 * c1 + c16 * c2), p)
        chat = chat[:, :samples].reshape(-1, *chat.shape[2:])[:B]   # (B, f, Mp)
        clo, chi = (x.to(torch.int8) for x in ntt.split_bytes(chat))
        Vp = b_planes(ctx.Winv_mma[pi])[:, :F, :F]           # (4, f, t)
        eq = "bfm,ft->bmt"
        c0 = int32_sum(mma(clo, Vp[0], eq) + mma(chi, Vp[2], eq))
        c1 = int32_sum(mma(clo, Vp[1], eq) + mma(chi, Vp[3], eq))
        if F > 128:                       # 257 F 2^15 would leave int32
            c1 = ntt.balanced_mod(c1, p)
        res.append(ntt.balanced_mod(int32_sum(c0 + 256 * c1), p)[:, :M])
    p0, p1 = ctx.primes
    q = ntt.balanced_mod(int32_sum((res[1] - res[0]) * ctx.crt_inv), p1)
    V = int32_sum(res[0] + q * p0).reshape(B, L, U, R, F)
    upd = sum((V[:, li] << (ctx.key_round_bits + ctx.key_limb_bits * li)) for li in range(L))
    upd = upd.transpose(-1, -2).reshape(B, U, N)               # acc[u][t*R + r]
    return wrap32(acc.to(torch.int64) + upd)


# --- K2: the direct negacyclic product on byte limbs -------------------------

def byte_limbs(v: torch.Tensor) -> torch.Tensor:
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
    dig = cmux_digits(acc, bara_i, tg)
    assert int(dig.abs().max()) <= 128
    dig = dig.to(torch.int8)                                   # (B, J, N)
    J = dig.shape[1]
    rows = J if rows is None else rows
    out = acc.to(torch.int64)
    for j0 in range(0, J, rows):
        share = key_step[j0:j0 + rows]
        pos, neg = byte_limbs(share), byte_limbs(-share.to(torch.int64))   # (4, j, U, N)
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
            out = wrap32(out + (int32_sum(s.to(torch.int64)) << (8 * t)))
    return out


# --- The cluster, narrow, stream and staged tiers -----------------------------

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
    keyp = key_planes(v1_loader(key8_step, K, M))           # (2, P, F, Kp, Mp)
    dig = cmux_digits(acc, bara_i, tg)
    dig = dig.reshape(B, -1, F, R).transpose(-1, -2).reshape(B, -1, F)
    dig = torch.nn.functional.pad(dig, (0, 0, 0, Kp - dig.shape[1]))   # (B, Kp, t)
    dplanes = ([dig.to(torch.int8)] if tg.halfBg <= 128
               else [x.to(torch.int8) for x in ntt.split_bytes(dig)])
    res = []
    for pi, p in enumerate(ctx.primes):
        c16 = int(ntt.balanced_mod(torch.tensor(1 << 16), p))
        Wp = b_planes(ctx.W_mma[pi])[:, :F, :F]              # (4, t, f)
        Vp = b_planes(ctx.Winv_mma[pi])[:, :F, :F]           # (4, f, t)
        chats = []
        for c in range(cluster):                              # block c: frequencies fs
            fs = slice(c * Fc, (c + 1) * Fc)
            c0 = mma(dplanes[0], Wp[0, :, fs], "bkt,tf->bkf")
            c1 = mma(dplanes[0], Wp[1, :, fs], "bkt,tf->bkf")
            if len(dplanes) == 2:
                c0 = c0 + mma(dplanes[1], Wp[2, :, fs], "bkt,tf->bkf")
                c1 = c1 + mma(dplanes[1], Wp[3, :, fs], "bkt,tf->bkf")
            c1 = ntt.balanced_mod(int32_sum(c1), p)
            dhat = ntt.balanced_mod(int32_sum(int32_sum(c0) + 256 * c1), p)
            lo, hi = (x.to(torch.int8) for x in ntt.split_bytes(dhat))    # (B, Kp, Fc)
            Alo, Ahi = keyp[0, pi, fs], keyp[1, pi, fs]                  # (Fc, Kp, Mp)
            eq = "bkf,fkm->bmf"
            c0 = int32_sum(mma(lo, Alo, eq))
            c1 = int32_sum(mma(hi, Alo, eq) + mma(lo, Ahi, eq))
            c2 = ntt.balanced_mod(int32_sum(mma(hi, Ahi, eq)), p)
            if Kp > 128:
                c1 = ntt.balanced_mod(c1, p)
            chats.append(ntt.balanced_mod(int32_sum(c0 + 256 * c1 + c16 * c2), p))   # (B, Mp, Fc)
        res.append(_cluster_inverse(chats, Vp, F, cluster, p)[:, :M])
    p0, p1 = ctx.primes
    q = ntt.balanced_mod(int32_sum((res[1] - res[0]) * ctx.crt_inv), p1)
    V = int32_sum(res[0] + q * p0).reshape(B, L, U, R, F)
    upd = sum((V[:, li] << (ctx.key_round_bits + ctx.key_limb_bits * li)) for li in range(L))
    return wrap32(acc.to(torch.int64) + upd.transpose(-1, -2).reshape(B, U, N))


def _digits_r_major(accf: torch.Tensor, bara_i: torch.Tensor, tg, R: int) -> torch.Tensor:
    """The narrow tier's digit pass: d = X^a acc - acc from the r-major
    accumulator accf (B, U, R, F), coefficient c = t R + r, each source
    coefficient src = c - a mod 2N read at row src mod R, column src // R
    mod F, negated from column F on; digits (B, J, N) as ``cmux_digits``."""
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
    and the inverse's rows m = (limb, u, r) of its pairs.  Each block
    receives the whole accumulator, r-major, as the owners push their slices,
    and forms every digit from it; its forward over its columns of W and its
    pointwise product over the key share that one bulk copy stages (bytes
    [(pi F + c Fc) T, (pi F + (c + 1) Fc) T) of the step's packed key, T =
    (Mp/16)(Kp/16)512) keep the shipped sums, nothing reduced before the
    products by 256 and c16; each row of its chat goes to the row's owner,
    which contracts its rows over every f, then takes the CRT and the limb
    sum into its slice."""
    tg = params.tgsw_params
    B, U, N = acc.shape
    R, F, L = ctx.R, ctx.F, ctx.key_limbs
    Kp, Mp = ntt.pad16(tg.kpl * R), ntt.pad16(L * U * R)
    Fc, P = F // cluster, U * R // cluster
    T = (Mp // 16) * (Kp // 16) * 512
    by_pair = acc.reshape(B, U, F, R).transpose(-1, -2).reshape(B, U * R, F)
    slices = [by_pair[:, c * P:(c + 1) * P] for c in range(cluster)]      # (B, P, F)
    accf = torch.cat(slices, dim=1).reshape(B, U, R, F)                   # the pushes
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
        Wp = b_planes(ctx.W_mma[pi])[:, :F, :F]              # (4, t, f)
        Vp = b_planes(ctx.Winv_mma[pi])[:, :F, :F]           # (4, f, t)
        chats = []
        for c in range(cluster):
            fs = slice(c * Fc, (c + 1) * Fc)
            c0 = mma(dplanes[0], Wp[0, :, fs], "bkt,tf->bkf")
            c1 = mma(dplanes[0], Wp[1, :, fs], "bkt,tf->bkf")
            if len(dplanes) == 2:
                c0 = c0 + mma(dplanes[1], Wp[2, :, fs], "bkt,tf->bkf")
                c1 = c1 + mma(dplanes[1], Wp[3, :, fs], "bkt,tf->bkf")
            dhat = ntt.balanced_mod(int32_sum(int32_sum(c0) + 256 * int32_sum(c1)), p)
            share = flat[(pi * F + c * Fc) * T:(pi * F + (c + 1) * Fc) * T]   # the bulk copy
            keyp = key_planes(share.reshape(1, Fc, Mp // 16, Kp // 16, 32, 16))[:, 0]
            eq = "nbkf,fkm->nbmf"
            lo, hi = (_mma_columns(x.to(torch.int8), samples) for x in ntt.split_bytes(dhat))
            c0 = int32_sum(mma(lo, keyp[0], eq))
            c1 = int32_sum(mma(hi, keyp[0], eq) + mma(lo, keyp[1], eq))
            c2 = int32_sum(mma(hi, keyp[1], eq))
            z = int32_sum(int32_sum(c0 + 256 * int32_sum(c1)) + int32_sum(c16 * c2))
            chats.append(ntt.balanced_mod(z, p)[:, :samples].reshape(-1, Mp, Fc)[:B])
        out = []
        for c in range(cluster):                              # the rows' owner
            mine = torch.cat([x[:, rows[c]] for x in chats], dim=-1)   # (B, L P, F)
            clo, chi = (x.to(torch.int8) for x in ntt.split_bytes(mine))
            eq = "bjf,ft->bjt"
            c0 = int32_sum(mma(clo, Vp[0], eq) + mma(chi, Vp[2], eq))
            c1 = int32_sum(mma(clo, Vp[1], eq) + mma(chi, Vp[3], eq))
            out.append(ntt.balanced_mod(int32_sum(c0 + 256 * c1), p))   # (B, L P, t)
        res.append(out)
    p0, p1 = ctx.primes
    own = []
    for c in range(cluster):
        q = ntt.balanced_mod(int32_sum((res[1][c] - res[0][c]) * ctx.crt_inv), p1)
        V = int32_sum(res[0][c] + q * p0).reshape(B, L, P, F)
        upd = sum((V[:, li] << (ctx.key_limb_bits * li)) for li in range(L))
        own.append(wrap32(slices[c].to(torch.int64) + upd))
    return torch.cat(own, dim=1).reshape(B, U, R, F).transpose(-1, -2).reshape(B, U, N)


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
    dig = cmux_digits(acc, bara_i, tg).to(torch.float64)            # (B, J, N), whole samples
    J, Ns = dig.shape[1], N // cluster
    pos, neg = byte_limbs(key_step), byte_limbs(-key_step.to(torch.int64))   # (4, J, U, N)
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
            part = int32_sum(s[:, :, j0:j0 + rows].sum(2))       # (B, 4, U, Ns)
            upd = sum(part[:, t] << (8 * t) for t in range(4))
            out[..., c * Ns:(c + 1) * Ns] = wrap32(out[..., c * Ns:(c + 1) * Ns] + upd)
    return out


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
    keyp = key_planes(v1_loader(key8_step, K, M))           # (2, P, F, Kp, Mp)
    dig = cmux_digits(acc, bara_i, tg)
    dig = dig.reshape(B, -1, F, R).transpose(-1, -2).reshape(B, -1, F)
    dig = torch.nn.functional.pad(dig, (0, 0, 0, Kp - dig.shape[1]))   # (B, Kp, t)
    dplanes = ([dig.to(torch.int8)] if tg.halfBg <= 128
               else [x.to(torch.int8) for x in ntt.split_bytes(dig)])
    res = []
    for pi, p in enumerate(ctx.primes):
        c16 = int(ntt.balanced_mod(torch.tensor(1 << 16), p))
        Wp = b_planes(ctx.W_mma[pi])[:, :F, :F]              # (4, t, f)
        Vp = b_planes(ctx.Winv_mma[pi])[:, :F, :F]           # (4, f, t)
        chats = []
        for c in range(cluster):
            chat = torch.empty((B, ntt.pad16(M), Fc), dtype=torch.int64)
            for f0 in range(c * Fc, (c + 1) * Fc, fs):        # a sub-chunk
                sub = slice(f0, f0 + fs)
                c0 = c1 = 0
                for kt in range(F // 32):                     # slab kt: t in [32 kt, 32 kt + 32)
                    ts = slice(32 * kt, 32 * kt + 32)
                    c0 = c0 + mma(dplanes[0][..., ts], Wp[0, ts, sub], "bkt,tf->bkf")
                    c1 = c1 + mma(dplanes[0][..., ts], Wp[1, ts, sub], "bkt,tf->bkf")
                    if len(dplanes) == 2:
                        c0 = c0 + mma(dplanes[1][..., ts], Wp[2, ts, sub], "bkt,tf->bkf")
                        c1 = c1 + mma(dplanes[1][..., ts], Wp[3, ts, sub], "bkt,tf->bkf")
                    int32_sum(c0), int32_sum(c1)            # the registers across slabs
                dhat = ntt.balanced_mod(int32_sum(c0 + 256 * ntt.balanced_mod(c1, p)), p)
                lo, hi = (x.to(torch.int8) for x in ntt.split_bytes(dhat))   # (B, Kp, fs)
                Alo, Ahi = keyp[0, pi, sub], keyp[1, pi, sub]
                eq = "bkf,fkm->bmf"
                d0 = int32_sum(mma(lo, Alo, eq))
                d1 = int32_sum(mma(hi, Alo, eq) + mma(lo, Ahi, eq))
                d2 = ntt.balanced_mod(int32_sum(mma(hi, Ahi, eq)), p)
                if Kp > 128:
                    d1 = ntt.balanced_mod(d1, p)
                chat[..., f0 - c * Fc:f0 - c * Fc + fs] = ntt.balanced_mod(
                    int32_sum(d0 + 256 * d1 + c16 * d2), p)
            chats.append(chat)
        res.append(_cluster_inverse(chats, Vp, F, cluster, p)[:, :M])
    p0, p1 = ctx.primes
    q = ntt.balanced_mod(int32_sum((res[1] - res[0]) * ctx.crt_inv), p1)
    V = int32_sum(res[0] + q * p0).reshape(B, L, U, R, F)
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
        c0 = int32_sum(mma(clo, Vp[0, :, ts], eq) + mma(chi, Vp[2, :, ts], eq))
        c1 = ntt.balanced_mod(
            int32_sum(mma(clo, Vp[1, :, ts], eq) + mma(chi, Vp[3, :, ts], eq)), p)
        out[..., ts] = ntt.balanced_mod(int32_sum(c0 + 256 * c1), p)
    return out


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
    pos, neg = byte_limbs(key_step), byte_limbs(-key_step.to(torch.int64))   # (4, J, U, N)
    rev = torch.cat([pos.flip(-1), neg.flip(-1)], dim=-1).to(torch.float64)     # (4, J, U, 2N)
    size = 1 << (N + Ns - 1).bit_length()
    upd = torch.zeros((B, U, N), dtype=torch.int64)
    for j0 in range(0, J, rows):
        share = cmux_digits(acc, bara_i, tg)[:, j0:j0 + rows].to(torch.float64)   # from acc
        dhat = torch.fft.rfft(share, size).conj()[:, None, :, None]
        for c in range(cluster):
            y0 = N - c * Ns - Ns
            win = rev[:, j0:j0 + rows, :, y0:y0 + N + Ns]
            corr = torch.fft.irfft(torch.fft.rfft(win, size)[None] * dhat, size)[..., :Ns]
            assert float((corr - corr.round()).abs().max()) < 0.25
            s = corr.round().to(torch.int64).flip(-1).sum(2)         # (B, 4, U, Ns)
            for t in range(4):                                       # a limb pass
                upd[..., c * Ns:(c + 1) * Ns] = wrap32(
                    upd[..., c * Ns:(c + 1) * Ns] + (int32_sum(s[:, t]) << (8 * t)))
    return wrap32(acc.to(torch.int64) + upd)


# --- The kernels' plans at a shape ---------------------------------------------

def check_kernel_domains(p, k1, k3, k2):
    """``p`` is in K3's and K2's domains, and in K1's where it has a context
    (``k1`` None: the refusal by name), at the plans given; each plan's
    shared memory a block within the card's."""
    tg = p.tgsw_params
    U, N = tg.tlwe_params.k + 1, tg.tlwe_params.N
    sctx = ntt.context_for_params(p, device="cpu")
    blind_rotate_v1.check_kernel_domain(U, sctx, tg)
    assert blind_rotate.crt_mma_plan(U, sctx, tg, blind_rotate_v1.STAGE_BYTES) == k3
    assert blind_rotate.crt_mma_smem_bytes(U, sctx, tg, blind_rotate_v1.STAGE_BYTES, k3[0],
                                           k3[2]) <= blind_rotate.SMEM_PER_BLOCK
    if k1 is None:
        with pytest.raises(ValueError, match=f"K1 .* has no context at N={N}"):
            ntt.kernel_context_for_params(p, device="cpu")
    else:
        kctx = ntt.kernel_context_for_params(p, device="cpu")
        blind_rotate.check_kernel_domain(U, kctx, tg)
        assert blind_rotate.crt_mma_plan(U, kctx, tg) == k1
    blind_rotate_compact.check_kernel_domain(p)
    assert blind_rotate_compact.kernel_plan(U, N, tg.kpl, tg.halfBg) == k2
    assert blind_rotate_compact.smem_bytes(
        U, N, tg.kpl, *k2, blind_rotate_compact.is_general(U, N, k2)) <= \
        blind_rotate.SMEM_PER_BLOCK
