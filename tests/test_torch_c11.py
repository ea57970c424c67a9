"""ROADMAP C11: the shapes up to N = 16384 that the reference computes and the card refused.

After C10 the kernels' domain checks refused hundreds of shapes with 8 <= N
<= 16384 that the reference computes: K2 bounded its int32 limb sum over the
whole ring (the reference's fused kernel bounds it per chunk of 128
coefficients), and every block of a cluster held the whole sample's digit
rows (K2) or its digits over all F (K1, K3).  K2 now bounds the sum per pass
and takes the digit rows a share at a time (its staged tier); K1 and K3
stream the digits through a block in k32 slabs and walk the frequencies in
sub-chunks (their stream tier).  Here: every shape of the grid passes the
three domain checks outside the named classes, and the port's NAND equals
the reference's word for word at two of the formerly refused shapes.  The
tiers' arithmetic is replayed block by block in
``tests/test_torch_tensor_core_emulation.py`` and held against the plain
versions on the card in ``tests/test_torch_card.py``.
"""

import functools
import types

import jax.numpy as jnp
import pytest

from eoc_tfhe_tpu.core import params as jparams

from eoc_tfhe_tpu_torch.core import bootstrap, params
from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1, ntt

from torch_reference import assert_port_nand_matches, keyset_pair, reference_nand

#: The grid: every power-of-two N from 8 to 16384, k = 1 to 4, Bgbit = 1 to
#: 15 and every l with l*Bgbit <= 32.
GRID = [(N, k, l, bg) for N in (8 << i for i in range(12)) for k in range(1, 5)
        for bg in range(1, 16) for l in range(1, 32 // bg + 1)]


def _plan_context(N: int, J: int, halfBg: int, primes: tuple[int, int]):
    """The fields of ``ntt.make_context`` that the plans and the domain
    checks read, without its matrices (which take seconds a prime at F >=
    1024); raises where ``make_context`` or ``kernel_context`` has no
    context, with their messages."""
    R = ntt._outer_split(N)
    F = N // R
    if primes == ntt.KERNEL_PRIMES:
        for p in primes:
            if (p - 1) % (2 * F):
                raise ValueError(f"K1 (blind_rotate_ntt) has no context at N={N}")
    else:
        for p in primes:
            if (p - 1) % (2 * F):
                raise ValueError(f"{2 * F} does not divide {p}-1")
    limbs, bits = ntt._choose_key_limbs(J, N, halfBg, primes)
    ctx = types.SimpleNamespace(N=N, R=R, F=F, primes=tuple(primes), key_limbs=limbs,
                                key_limb_bits=bits, key_round_bits=0)
    ctx.crt_inv = ntt.NttContext.crt_inv.fget(ctx)
    return ctx


@pytest.mark.parametrize("N,k,l,bg", [(1024, 2, 3, 7), (2048, 4, 32, 1), (64, 3, 5, 5)])
def test_plan_context_has_the_contexts_fields(N, k, l, bg):
    """The grid's stand-in context carries the real one's fields, over both
    prime pairs."""
    p = params.test_params(N=N, k=k, l=l, Bgbit=bg)
    tg = p.tgsw_params
    for real in (ntt.context_for_params(p, device="cpu"),
                 ntt.kernel_context_for_params(p, device="cpu")):
        light = _plan_context(N, tg.kpl, tg.halfBg, real.primes)
        for field in ("N", "R", "F", "primes", "key_limbs", "key_limb_bits", "key_round_bits",
                      "crt_inv"):
            assert getattr(light, field) == getattr(real, field), field


@functools.lru_cache(maxsize=None)
def _context(N: int, J: int, halfBg: int, primes: tuple[int, int]):
    """One stand-in context per (N, J, halfBg, primes), or the refusal's text."""
    try:
        return _plan_context(N, J, halfBg, primes)
    except ValueError as e:
        return str(e)


#: The named classes that stay refused on the grid, by the text of their
#: refusal: no context (K1's primes have no 2F-th root at N >= 4096; no
#: key-limb split meets the CRT bound of either pair) and C1 (K2's int8
#: digits at halfBg > 128).
NO_CONTEXT = ("has no context at N=", "no key-limb split satisfies the CRT bound")
C1 = "> 128: the compact and rows eval-key forms are exact only for int8 gadget digits"

#: The 66 shapes (N, k, l, Bgbit) that no kernel took on the card after C10
#: (K2 and K3 both refused them; K1 has no context there).
NO_FORM = ([(16384, 1, l, bg) for bg in range(3, 9) for l in range(6, 32 // bg + 1)]
           + [(16384, 2, l, bg) for bg in range(3, 9) for l in range(4, 32 // bg + 1)]
           + [(16384, 3, l, bg) for bg in range(3, 9) for l in range(3, 32 // bg + 1)]
           + [(8192, 2, l, bg) for bg in range(3, 9) for l in range(8, 32 // bg + 1)]
           + [(8192, 3, l, bg) for bg in range(3, 9) for l in range(6, 32 // bg + 1)])


def test_kernel_domains_are_closed_up_to_n16384():
    """Every shape of the grid passes K2's and K3's domain checks, and K1's
    wherever K1 has a context; the only refusals are the named classes (no
    context, and halfBg > 128 for K2), the 66 shapes that no kernel took
    among those passed, and every plan's shared memory within the card's.
    (N < 8 and l*Bgbit > 32, the other two classes, lie outside the grid:
    ``tests/test_torch_blind_rotate.py::test_kernel_domains_refuse_by_name``.)"""
    assert len(NO_FORM) == 66
    taken = {"K1": set(), "K2": set(), "K3": set()}
    tiers = {"K1": 0, "K2": 0, "K3": 0}
    for N, k, l, bg in GRID:
        p = params.test_params(N=N, k=k, l=l, Bgbit=bg, n=4)
        tg = p.tgsw_params
        U = k + 1
        for name, primes, check, stage in (
                ("K1", ntt.KERNEL_PRIMES, blind_rotate.check_kernel_domain, 0),
                ("K3", ntt.DEFAULT_PRIMES, blind_rotate_v1.check_kernel_domain,
                 blind_rotate_v1.STAGE_BYTES)):
            ctx = _context(N, tg.kpl, tg.halfBg, primes)
            if isinstance(ctx, str):
                assert any(c in ctx for c in NO_CONTEXT), ctx
                assert name == "K1" or tg.halfBg > 128, (N, k, l, bg, ctx)
                continue
            check(U, ctx, tg)
            samples, _, cluster, stream = blind_rotate._plan(U, ctx, tg, stage)
            assert blind_rotate.crt_mma_smem_bytes(U, ctx, tg, stage, samples, cluster,
                                                   stream) <= blind_rotate.SMEM_PER_BLOCK
            tiers[name] += stream is not None
            taken[name].add((N, k, l, bg))
        if tg.halfBg > 128:
            with pytest.raises(ValueError, match=C1):
                blind_rotate_compact.check_kernel_domain(p)
            continue
        blind_rotate_compact.check_kernel_domain(p)
        plan = blind_rotate_compact.kernel_plan(U, N, tg.kpl, tg.halfBg)
        staged = blind_rotate_compact.is_staged(U, N, tg.kpl, tg.halfBg)
        assert plan[2] * N * tg.halfBg * 128 < 1 << 31            # a pass's limb sum
        assert blind_rotate_compact.smem_bytes(
            U, N, tg.kpl, *plan, blind_rotate_compact.is_general(U, N, plan, staged),
            staged) <= blind_rotate.SMEM_PER_BLOCK
        tiers["K2"] += staged
        taken["K2"].add((N, k, l, bg))
    assert set(NO_FORM) <= taken["K2"] and set(NO_FORM) <= taken["K3"]
    assert all(N < 4096 for N, *_ in taken["K1"])
    # every shape K2 takes (halfBg <= 128), and K3 wherever DEFAULT_PRIMES
    # have a key-limb split: all of the grid's 4,848 shapes but those
    assert len(taken["K2"]) == sum(1 for *_, bg in GRID if bg <= 8)
    assert tiers["K1"] > 0 and tiers["K2"] > 0 and tiers["K3"] > 0, tiers


# --- The reference's NAND at two formerly refused shapes -----------------------

#: (N, k, l, Bgbit) of each shape and the port's forms held word for word
#: against the shape's one reference NAND (its fused form, the reference's
#: cheapest exact one here): K2's limb sum per pass (N = 16384 k = 2 l = 3
#: Bgbit = 8, refused at 2,415,919,104), K2's staged tier and K3's stream
#: tier (N = 8192 k = 2 l = 8 Bgbit = 4).
C11_NAND = {"N16384_k2_l3_bg8": ((16384, 2, 3, 8), ("compact",)),
            "N8192_k2_l8_bg4": ((8192, 2, 8, 4), ("compact", "ntt_scan"))}


def _params(shape):
    N, k, l, bg = C11_NAND[shape][0]
    return jparams.test_params(N=N, k=k, l=l, Bgbit=bg, n=4)


@pytest.mark.parametrize("shape,form", [(s, f) for s, (_, forms) in C11_NAND.items()
                                        for f in forms])
def test_c11_nand_matches_reference_word_for_word(shape, form):
    """At N = 16384 k = 2 l = 3 Bgbit = 8 (compact) and N = 8192 k = 2 l = 8
    Bgbit = 4 (compact and ntt_scan) the port's NAND has the words, the
    variance rail and the decryption of the shape's one reference NAND."""
    assert_port_nand_matches(reference_nand(_params(shape), 71), form)


def test_c11_rows_form_refuses_where_the_reference_asserts():
    """The rows form keeps the reference's whole-ring bound: at N = 16384 k =
    2 l = 3 Bgbit = 8 the reference's rows scan asserts (J N halfBg 128 =
    2,415,919,104) and the port's rows key refuses by name, while the fused
    (compact) form, bounded per pass, takes the shape."""
    p = _params("N16384_k2_l3_bg8")
    tk = keyset_pair(p, 71).port
    with pytest.raises(ValueError, match=r"rows eval-key form's int32 sum reaches "
                                         r"2,415,919,104 >= 2\^31"):
        bootstrap.prepare_eval_key(tk.cloud, p)
    tg = p.tgsw_params
    with pytest.raises(AssertionError, match="int32 accumulation would overflow"):
        from eoc_tfhe_tpu.ops import polymul as jpolymul
        jpolymul.small_by_torus_matmul(
            jnp.zeros((1, tg.kpl, p.N), jnp.int32),
            jnp.zeros((tg.kpl, tg.tlwe_params.k + 1, p.N), jnp.int32), x_bound=tg.halfBg)
    assert blind_rotate_compact.kernel_plan(3, p.N, tg.kpl, tg.halfBg)[2] <= 7
