"""ROADMAP C12: the rings past N = 16384 that the reference's fused form computes.

The reference's fused kernel bounds its int32 sums per chunk of 128
coefficients, so it has no ring limit.  Past N = 16384 the port's compact
form had no exact plain product (the "ntt_scan" context it multiplied
through has no root at N = 32768) and K2 refused most shapes by shared
memory (a sample's share of the accumulators outgrew a block of a cluster of
8) and, at N >= 131072, by its limb sum over one digit row and the whole
ring.  The plain version now multiplies through ``ntt.wide_context`` (three
primes, inner length 2048) from N = 32768 on, and K2 takes a global tier
whose accumulators and digits live in device memory and whose int32 sums are
bounded per contraction chunk.  Here: the domain of the C12 grid, the
reference's fused NAND word for word at N = 32768, the new plain product at
N = 65536 against an int64 schoolbook, and the global tier's arithmetic
replayed pass by pass.  The kernel is held against the plain version on the
card in ``tests/test_torch_card.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.ops import ntt as jntt
from eoc_tfhe_tpu.ops import pallas_blindrot as jpb

from eoc_tfhe_tpu_torch.core import keys, params
from eoc_tfhe_tpu_torch.core.numeric import wrap32
from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, keyswitch, ntt, polymul

from torch_emulation import I32, byte_limbs, cmux_digits, int32_sum
from torch_reference import assert_port_nand_matches, reference_nand, reference_scan
from torch_reference_ntt import fast_reference_matrices

#: The C12 grid: N = 32768 and 65536, k = 1 to 4, Bgbit = 1 to 8 (halfBg <=
#: 128, K2's domain) and every l with l*Bgbit <= 32.
GRID = [(N, k, l, bg) for N in (32768, 65536) for k in range(1, 5) for bg in range(1, 9)
        for l in range(1, 32 // bg + 1)]


def test_c12_grid_passes_k2s_domain():
    """Every shape of the C12 grid passes K2's domain check at a plan whose
    shared memory fits a block and whose every pass keeps its limb sums in
    int32: over the whole ring (the plans up to N = 16384) or over one
    contraction chunk (the global tier); the plain product's three-prime plan
    has a key-limb split at each.  N = 131072 and 262144 at k = 1 and halfBg
    = 128, where one digit row's sum over the ring reaches 2^31, pass too."""
    tiers = {"staged": 0, "global": 0}
    for N, k, l, bg in GRID + [(131072, 1, 3, 8), (262144, 1, 3, 8)]:
        p = params.test_params(N=N, k=k, l=l, Bgbit=bg, n=4)
        tg = p.tgsw_params
        U, J = k + 1, tg.kpl
        blind_rotate_compact.check_kernel_domain(p)
        plan = blind_rotate_compact._plan(U, N, J, tg.halfBg)
        samples, limbs, rows, cluster, general, staged, global_tier = plan
        assert blind_rotate_compact.smem_bytes(U, N, J, samples, limbs, rows, cluster, general,
                                               staged, global_tier) <= blind_rotate.SMEM_PER_BLOCK
        chunk = blind_rotate_compact.GLOBAL_CHUNK if global_tier else N
        assert rows * chunk * tg.halfBg * 128 < I32, (N, k, l, bg, plan)
        assert global_tier == blind_rotate_compact.is_global(U, N, J, tg.halfBg)
        tiers["staged"] += staged
        tiers["global"] += global_tier
        limbs, bits = ntt._choose_key_limbs(J, N, tg.halfBg, ntt.WIDE_PRIMES)
        assert 2 * J * N * tg.halfBg * ((1 << (bits - 1)) + 1) < np.prod(
            [int(q) for q in ntt.WIDE_PRIMES], dtype=object)
    assert tiers["staged"] > 0 and tiers["global"] > 0, tiers
    for N in (131072, 262144):
        assert blind_rotate_compact.max_rows(N, 128) == 0
        assert blind_rotate_compact.is_global(2, N, 6, 128)


# --- The reference's fused NAND at N = 32768 ------------------------------------

#: The shape and the keyset's seed (the port's keygen) of the reference's NAND
#: at N = 32768, where it computes one form, the fused one (its Pallas K2 in
#: interpret mode).
C12_NAND = (jparams.test_params(N=32768, k=1, l=3, Bgbit=8, n=4), 71)


def test_c12_nand_matches_reference_word_for_word():
    """At N = 32768 k = 1 l = 3 Bgbit = 8 the port's compact NAND (its plain
    version over ``ntt.wide_context``) has the words, the variance rail and
    the decryption of the reference's fused NAND; the "ntt_scan" form raises
    there in both packages."""
    ref = reference_nand(*C12_NAND)
    assert ref.form == "fused"
    p = ref.params
    assert_port_nand_matches(ref, "compact")
    with pytest.raises(ValueError, match="8192 does not divide 61441-1"):
        ntt.context_for_params(p, device="cpu")
    with fast_reference_matrices(), pytest.raises(ValueError,
                                                  match="8192 does not divide 61441-1"):
        jntt.context_for_params(p)           # after its first prime's matrices at F = 4096


# --- The plain product at N = 65536 ------------------------------------------------

def test_wide_product_matches_an_int64_schoolbook_at_n65536():
    """One step's product of the plain version past N = 16384 (``ntt.wide_context``:
    R = 32, F = 2048, three primes) for one digit row by one key row equals
    the int64 schoolbook negacyclic product mod 2^32 (numpy's direct
    convolution; every partial sum below 128 * 2^31 * 2^16 = 2^54 < 2^63)."""
    N = 65536
    rng = np.random.default_rng(12)
    digits = (rng.integers(0, 2, N) * 256 - 128).astype(np.int32)   # +-128: the largest
    row = rng.integers(-I32, I32, N, dtype=np.int64).astype(np.int32)
    ctx = ntt.wide_context(N, 1, 128, device="cpu")
    assert (ctx.R, ctx.F, ctx.primes) == (32, 2048, ntt.WIDE_PRIMES)
    key_step = ntt.kernel_key_residues(torch.from_numpy(row)[None, None, None], ctx)[0]
    got = ntt.external_product_ntt(torch.from_numpy(digits)[None, None], key_step, ctx)
    lin = np.convolve(digits.astype(np.int64), row.astype(np.int64))     # length 2N - 1
    want = lin[:N].copy()
    want[:N - 1] -= lin[N:]                                               # X^N = -1
    np.testing.assert_array_equal(got[0, 0].numpy(), wrap32(torch.from_numpy(want)).numpy())


def test_plain_context_switches_to_the_wide_plan_at_n32768():
    """The plain version keeps the "ntt_scan" context up to N = 16384 and takes
    the wide plan from N = 32768 on, where that context has no root."""
    small = params.test_params(N=16384, k=1, l=3, Bgbit=8)
    ctx = blind_rotate_compact.plain_context(small, device="cpu")
    assert (ctx.primes, ctx.R, ctx.F) == (ntt.DEFAULT_PRIMES, 8, 2048)
    for N, R in ((32768, 16), (65536, 32)):
        ctx = blind_rotate_compact.plain_context(params.test_params(N=N, k=1, l=3, Bgbit=8),
                                                 device="cpu")
        assert (ctx.primes, ctx.R, ctx.F) == (ntt.WIDE_PRIMES, R, 2048)


def test_garner_crt_gives_the_pair_crt_and_the_exact_integer():
    """``ntt.crt`` over three primes returns the integer of |V| < P/2 whose
    residues it is given, and over two primes that integer too, the values
    of the two-prime formula r0 + balanced_mod((r1 - r0) crt_inv, p2) p1."""
    rng = np.random.default_rng(13)
    ctx3 = ntt.wide_context(32768, 6, 128, device="cpu")
    P = int(np.prod([int(q) for q in ntt.WIDE_PRIMES], dtype=object))
    V = torch.from_numpy(rng.integers(-(P // 2), P // 2, 4096, dtype=np.int64))
    res = [ntt.balanced_mod(V, q) for q in ntt.WIDE_PRIMES]
    assert torch.equal(ntt.crt(res, ctx3), V)
    ctx2 = ntt.context_for_params(params.test_params(N=64), device="cpu")
    V2 = V % 100_000_000 - 50_000_000
    r0, r1 = [ntt.balanced_mod(V2, q) for q in ctx2.primes]
    pair = r0 + ntt.balanced_mod((r1 - r0) * ctx2.crt_inv, ctx2.primes[1]) * ctx2.primes[0]
    assert torch.equal(ntt.crt([r0, r1], ctx2), V2)
    assert torch.equal(pair, V2)


def test_global_tier_refuses_by_name_past_the_cards_memory(monkeypatch):
    """The global tier needs B U N 4 + B J N bytes of device memory; what the
    card cannot hold is refused by name with the bytes, before any launch."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 1 << 20)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    need = 4096 * 3 * 65536 * 4 + 4096 * 9 * 65536
    with pytest.raises(ValueError, match=rf"K2 \(blind_rotate_compact\) needs {need:,} bytes "
                                         rf"of device memory .*; the card has "
                                         rf"{(1 << 30) + (1 << 20):,} free"):
        blind_rotate_compact._check_device_memory(need, torch.device("cuda"), "a test")
    blind_rotate_compact._check_device_memory(1 << 30, torch.device("cuda"), "a test")


def test_keyswitch_table_is_split_a_chunk_at_a_time():
    """The keyswitch table's limbs, split ``_PREP_ROWS`` input rows at a time
    (the whole table's int64 temporaries outgrew the card at n_in = 65536,
    N = 32768 k = 2), equal the split of the whole table."""
    rng = np.random.default_rng(14)
    n_in, t, base, m = 2 * keyswitch._PREP_ROWS + 5, 3, 4, 7
    table = torch.from_numpy(rng.integers(-I32, I32, (n_in, t, base, m), dtype=np.int64)
                             .astype(np.int32))
    got = keyswitch.prepare_keyswitch_matmul(keys.KeySwitchKey(ks=table, variance=None))
    whole = table.clone()
    whole[:, :, 0, :] = 0
    want = polymul.decompose_signed_limbs(whole).to(torch.float32)
    assert torch.equal(got, want.reshape(n_in * t * base, m * polymul.LIMBS))


def test_keygen_product_is_taken_a_column_block_at_a_time(monkeypatch):
    """The keygen-side Toeplitz product, a block of ``TOEPLITZ_COLS`` output
    coefficients at a time (the whole float64 block is 34 GB at N = 65536),
    equals the reference's whole-block product, a ragged last block included."""
    from eoc_tfhe_tpu.ops import polymul as jpoly
    monkeypatch.setattr(polymul, "TOEPLITZ_COLS", 48)
    rng = np.random.default_rng(15)
    a = rng.integers(-I32, I32, (3, 2, 256), dtype=np.int64).astype(np.int32)
    key = rng.integers(0, 2, (2, 256)).astype(np.int32)
    want = np.asarray(jpoly.torus_by_small_shared_matmul(jnp.asarray(a), jnp.asarray(key)))
    got = polymul.torus_by_small_shared_matmul(torch.from_numpy(a), torch.from_numpy(key))
    np.testing.assert_array_equal(got.numpy(), want)


# --- The global tier's arithmetic, pass by pass -----------------------------------

def emulate_k2_global_step(acc, key_step, bara_i, params, tile, chunk, rows):
    """One CMux step of K2's global tier: the digits once (the device scratch);
    each block owns ``tile`` outputs of one polynomial, and each pass takes
    ``rows`` digit rows of one chunk of ``chunk`` input coefficients against
    the window y in [N - c0 - tile + r0, + tile + chunk) of each row's byte
    limbs [k reversed | -k reversed]; output c0 + o of limb t is sum_r
    window[tile - 1 - o + r] d[r0 + r], an int32 sum over the pass's rows and
    chunk (asserted inside int32), added into the block's sums shifted by 8t
    mod 2^32; the sums are added into acc after the last pass.  (The
    correlation runs as a float64 FFT, rounded: every sum is an integer below
    2^31, which the FFT holds within 0.25.)"""
    tg = params.tgsw_params
    B, U, N = acc.shape
    J = tg.kpl
    dig = cmux_digits(acc, bara_i, tg).to(torch.float64)              # (B, J, N)
    pos, neg = byte_limbs(key_step), byte_limbs(-key_step.to(torch.int64))   # (4, J, U, N)
    rev = torch.cat([pos.flip(-1), neg.flip(-1)], dim=-1).to(torch.float64)     # (4, J, U, 2N)
    size = 1 << (tile + 2 * chunk - 1).bit_length()
    out = acc.to(torch.int64)
    for c0 in range(0, N, tile):
        sums = torch.zeros((B, U, tile), dtype=torch.int64)
        for j0 in range(0, J, rows):
            for r0 in range(0, N, chunk):
                y0 = N - c0 - tile + r0
                win = rev[:, j0:j0 + rows, :, y0:y0 + tile + chunk]     # (4, jn, U, .)
                d = dig[:, j0:j0 + rows, r0:r0 + chunk]                  # (B, jn, chunk)
                corr = torch.fft.irfft(torch.fft.rfft(win, size)[None]
                                       * torch.fft.rfft(d, size).conj()[:, None, :, None],
                                       size)[..., :tile]
                assert float((corr - corr.round()).abs().max()) < 0.25
                s = corr.round().to(torch.int64).flip(-1).sum(2)         # (B, 4, U, tile)
                for t in range(4):
                    sums = wrap32(sums + (int32_sum(s[:, t]) << (8 * t)))
        out[..., c0:c0 + tile] = wrap32(out[..., c0:c0 + tile] + sums)
    return out


@pytest.mark.parametrize("tile,chunk,rows", [(256, 128, 5), (1024, 256, 12), (512, 1024, 1)])
def test_k2_global_emulation_matches_reference_scan(tile, chunk, rows):
    """K2's global tier at N = 1024 k = 2 l = 4 Bgbit = 6 (J = 12), block by
    block and pass by pass over tiles, chunks and row shares of several
    sizes (the plan is an argument: at this shape the launcher takes an
    instantiation), gives the reference's exact scan bit for bit, every pass's
    limb sums inside int32."""
    p = jparams.test_params(N=1024, k=2, l=4, Bgbit=6)
    rows_, acc0, bara, want = reference_scan(p, 2, 3, 34)
    key = blind_rotate_compact.prepare_compact_bk(torch.from_numpy(rows_))
    acc = torch.from_numpy(acc0)
    for i in range(2):
        acc = emulate_k2_global_step(acc, key[i], torch.from_numpy(bara[i]), p, tile, chunk,
                                     rows)
    np.testing.assert_array_equal(acc.numpy(), want)


def test_k2_global_pass_bound_is_the_reference_chunk_rule():
    """K2's global tier bounds the limb sum per pass of ``GLOBAL_CHUNK``
    coefficients, as the reference's fused kernel bounds it per chunk (J C
    halfBg 128 < 2^31 with C = min(128, N), ``pallas_blindrot.py:135``): at N
    = 131072 k = 1 l = 3 Bgbit = 8 one digit row's sum over the ring reaches
    2^31 (no plan of the other tiers has a row) while the chunk rule holds,
    and the global tier's plan keeps rows * GLOBAL_CHUNK * halfBg * 128 below
    2^31 (``chunk_rows`` = 127 rows, N not in it)."""
    p = jparams.test_params(N=131072, k=1, l=3, Bgbit=8)
    tg = p.tgsw_params
    J, N = tg.kpl, tg.tlwe_params.N
    assert N * tg.halfBg * 128 == I32
    assert J * jpb.chunk_size_for(N) * tg.halfBg * 128 < I32
    assert blind_rotate_compact.max_rows(N, tg.halfBg) == 0
    assert blind_rotate_compact.chunk_rows(tg.halfBg) == 127
    plan = blind_rotate_compact.kernel_plan(2, N, J, tg.halfBg)
    assert blind_rotate_compact.is_global(2, N, J, tg.halfBg)
    assert plan == (8, 4, 3, 1)
    assert plan[2] * blind_rotate_compact.GLOBAL_CHUNK * tg.halfBg * 128 < I32


def test_k2_global_plan_is_four_limbs_and_at_most_three_rows():
    """The global tier's one plan: 8 samples, the four key limbs and min(J,
    ``GLOBAL_ROWS``) digit rows a pass, whose shared memory (217,744 bytes)
    does not depend on U, N or J and fits a block where a fourth row
    (246,544) does not; its rows keep the chunk rule at halfBg = 128.  The
    launcher's constants in ``csrc/blind_rotate_compact.cu`` are the
    mirror's."""
    src = (blind_rotate_compact.__file__.rsplit("/ops/", 1)[0]
           + "/csrc/blind_rotate_compact.cu")
    text = open(src).read()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (kGlobal\w+) = (\d+);", text)}
    assert consts["kGlobalChunk"] == blind_rotate_compact.GLOBAL_CHUNK
    assert consts["kGlobalSamples"] == blind_rotate_compact.GLOBAL_SAMPLES
    assert consts["kGlobalRows"] == blind_rotate_compact.GLOBAL_ROWS == 3

    def smem(U, N, J, rows):
        return blind_rotate_compact.smem_bytes(U, N, J, 8, 4, rows, 1, True, False, True)

    assert smem(2, 32768, 6, 3) == smem(5, 262144, 32, 3) == 217_744
    assert smem(2, 32768, 6, 3) <= blind_rotate.SMEM_PER_BLOCK < smem(2, 32768, 6, 4) == 246_544
    assert blind_rotate_compact.GLOBAL_ROWS <= blind_rotate_compact.chunk_rows(128)
    for k, l, bg in ((1, 1, 8), (1, 3, 8), (2, 3, 8), (4, 8, 4), (3, 32, 1)):
        J = (k + 1) * l
        assert blind_rotate_compact.is_global(k + 1, 65536, J, 1 << (bg - 1))
        assert blind_rotate_compact.kernel_plan(k + 1, 65536, J, 1 << (bg - 1)) == (
            8, 4, min(J, 3), 1)
