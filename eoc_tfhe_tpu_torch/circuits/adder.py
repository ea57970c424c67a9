"""Homomorphic integer circuits over bootstrapped gates.

Port of ``eoc_tfhe_tpu/circuits/adder.py``: ripple-carry add, ripple-borrow
subtract, an array multiplier, comparison, equality and word select, all on
bit batches of shape (nbits, ...), LSB first.  Every gate call is batched
over the trailing batch; the carry chain is sequential.

Fast mode (the default): the carry-save identity gives the full adder in one
MAJ bootstrap per bit, the sum bit is a linear combination (exact on the
+-1/8 encoding), and one batched refresh bootstrap over all sum bits resets
their noise.  An 8-bit add is 9 blind-rotation calls instead of the classic
XOR/XOR/MUX chain's 32.
"""

from __future__ import annotations

import torch

from ..core import gates
from ..core.bootstrap import EvalKey
from ..core.lwe import (LweCiphertext, lwe_add, lwe_add_mul, lwe_index, lwe_negate,
                        lwe_noiseless_trivial, lwe_stack, lwe_sub_mul)
from ..core.params import GateBootstrappingParams

RIPPLE_MODES = ("fast", "raw", "classic")


def _false(like: LweCiphertext, params: GateBootstrappingParams) -> LweCiphertext:
    """The constant 0 bit for each sample of a (nbits, ...) batch, on its device."""
    return gates.constant(torch.zeros(tuple(like.b.shape[1:]), dtype=torch.bool),
                          params, device=like.b.device)


def _check_mode(mode: str) -> None:
    if mode not in RIPPLE_MODES:
        raise ValueError(f"unknown ripple mode {mode!r}; 'fast', 'raw' or 'classic'")


def full_adder(a: LweCiphertext, b: LweCiphertext, carry: LweCiphertext,
               ek: EvalKey, params: GateBootstrappingParams
               ) -> tuple[LweCiphertext, LweCiphertext]:
    """(sum, carry_out): two XORs and one MUX; carry_out = MUX(a XOR b, carry, a)."""
    t = gates.xor_(a, b, ek, params)
    s = gates.xor_(t, carry, ek, params)
    return s, gates.mux(t, carry, a, ek, params)


def full_adder_fast(a: LweCiphertext, b: LweCiphertext, carry: LweCiphertext,
                    ek: EvalKey, params: GateBootstrappingParams
                    ) -> tuple[LweCiphertext, LweCiphertext]:
    """(sum, carry_out) in one bootstrap: carry_out = MAJ(a, b, c) and
    enc(a^b^c) = enc(a) + enc(b) + enc(c) - 2 enc(MAJ), exact on +-1/8.

    carry_out is a fresh bootstrap output; the sum is linear, with
    var(a) + var(b) + var(c) + 4 var(carry_out), tracked.
    """
    cout = gates.maj(a, b, carry, ek, params)
    return lwe_sub_mul(lwe_add(lwe_add(a, b), carry), 2, cout), cout


def half_adder_fast(a: LweCiphertext, b: LweCiphertext, ek: EvalKey,
                    params: GateBootstrappingParams
                    ) -> tuple[LweCiphertext, LweCiphertext]:
    """(sum, carry) in one bootstrap: carry = AND(a, b) and
    enc(a^b) = enc(a) + enc(b) - 2 enc(a&b) - 1/8, exact on +-1/8."""
    carry = gates.and_(a, b, ek, params)
    s = lwe_sub_mul(lwe_add(a, b), 2, carry)
    off = lwe_noiseless_trivial(
        torch.full(tuple(s.b.shape), -gates.MU_BOOL, dtype=torch.int32, device=s.b.device),
        s.n)
    return lwe_add(s, off), carry


def _lwe_broadcast(ct: LweCiphertext, k: int) -> LweCiphertext:
    """Prepend an axis of size k that shares one operand across bits (views)."""
    return LweCiphertext(a=ct.a.expand((k,) + tuple(ct.a.shape)),
                         b=ct.b.expand((k,) + tuple(ct.b.shape)),
                         current_variance=ct.current_variance.expand(
                             (k,) + tuple(ct.current_variance.shape)))


def _refresh_stacked(sums: list[LweCiphertext], ek: EvalKey,
                     params: GateBootstrappingParams) -> LweCiphertext:
    """One batched refresh bootstrap over all bit positions at once."""
    return gates.refresh(lwe_stack(sums), ek, params)


def ripple_mul(a_bits: LweCiphertext, b_bits: LweCiphertext, ek: EvalKey,
               params: GateBootstrappingParams) -> tuple[LweCiphertext, None]:
    """n-bit product mod 2^n, LSB first: array multiplication with the fast
    adder.  Partial-product row i is one batched AND, added at offset i by a
    fast ripple with one batched refresh per row.  Returns (prod_bits, None).
    """
    nbits = a_bits.b.shape[0]
    pp0 = gates.and_(_lwe_broadcast(lwe_index(a_bits, 0), nbits), b_bits, ek, params)
    acc = [lwe_index(pp0, j) for j in range(nbits)]
    for i in range(1, nbits):
        w = nbits - i
        pp = gates.and_(_lwe_broadcast(lwe_index(a_bits, i), w),
                        lwe_index(b_bits, slice(0, w)), ek, params)
        carry = _false(a_bits, params)
        sums = []
        for j in range(w):
            s, carry = full_adder_fast(acc[i + j], lwe_index(pp, j), carry, ek, params)
            sums.append(s)
        refreshed = _refresh_stacked(sums, ek, params)
        for j in range(w):
            acc[i + j] = lwe_index(refreshed, j)
    return lwe_stack(acc), None


def ripple_carry_add(a_bits: LweCiphertext, b_bits: LweCiphertext, ek: EvalKey,
                     params: GateBootstrappingParams, mode: str = "fast"
                     ) -> tuple[LweCiphertext, LweCiphertext]:
    """n-bit ripple-carry addition, LSB first on the leading axis.

    mode "fast": one MAJ bootstrap per bit plus one batched refresh of all
    sum bits; "raw": the same without the refresh (the sum bits keep their
    linear variance); "classic": the XOR/XOR/MUX full adder.
    Returns (sum_bits (nbits, ...), final carry).
    """
    _check_mode(mode)
    carry = _false(a_bits, params)
    adder = full_adder if mode == "classic" else full_adder_fast
    sums = []
    for i in range(a_bits.b.shape[0]):
        s, carry = adder(lwe_index(a_bits, i), lwe_index(b_bits, i), carry, ek, params)
        sums.append(s)
    if mode == "fast":
        return _refresh_stacked(sums, ek, params), carry
    return lwe_stack(sums), carry


def ripple_borrow_sub(a_bits: LweCiphertext, b_bits: LweCiphertext, ek: EvalKey,
                      params: GateBootstrappingParams, mode: str = "fast"
                      ) -> tuple[LweCiphertext, LweCiphertext]:
    """n-bit ripple-borrow subtraction a - b, LSB first.

    Fast: with u = NOT a, borrow_out = MAJ(u, b, borrow_in) and
    enc(diff) = 2 enc(borrow_out) - (enc(u) + enc(b) + enc(c)), then one
    batched refresh ("raw" skips it).  "classic": XOR/XOR and
    borrow_out = MUX(a XOR b, b, borrow_in).
    Returns (diff_bits, final borrow); borrow = 1 means a < b.
    """
    _check_mode(mode)
    borrow = _false(a_bits, params)
    diffs = []
    for i in range(a_bits.b.shape[0]):
        ai, bi = lwe_index(a_bits, i), lwe_index(b_bits, i)
        if mode == "classic":
            t = gates.xor_(ai, bi, ek, params)
            d = gates.xor_(t, borrow, ek, params)
            borrow = gates.mux(t, bi, borrow, ek, params)
        else:
            u = gates.not_(ai)
            bout = gates.maj(u, bi, borrow, ek, params)
            d = lwe_add_mul(lwe_negate(lwe_add(lwe_add(u, bi), borrow)), 2, bout)
            borrow = bout
        diffs.append(d)
    if mode == "fast":
        return _refresh_stacked(diffs, ek, params), borrow
    return lwe_stack(diffs), borrow


def compare_lt(a_bits: LweCiphertext, b_bits: LweCiphertext, ek: EvalKey,
               params: GateBootstrappingParams) -> LweCiphertext:
    """Unsigned a < b: the final borrow of the subtraction, one MAJ bootstrap
    per bit, without the difference."""
    lt = _false(a_bits, params)
    for i in range(a_bits.b.shape[0]):
        lt = gates.maj(gates.not_(lwe_index(a_bits, i)), lwe_index(b_bits, i), lt, ek, params)
    return lt


def equals(a_bits: LweCiphertext, b_bits: LweCiphertext, ek: EvalKey,
           params: GateBootstrappingParams) -> LweCiphertext:
    """Bitwise equality: one batched XNOR, then log2(n) batched AND levels
    (halves against halves; an odd leftover rides along)."""
    eqs = gates.xnor(a_bits, b_bits, ek, params)
    m = a_bits.b.shape[0]
    while m > 1:
        half = m // 2
        merged = gates.and_(lwe_index(eqs, slice(0, half)),
                            lwe_index(eqs, slice(half, 2 * half)), ek, params)
        if m % 2:
            tail = lwe_index(eqs, slice(2 * half, m))
            merged = LweCiphertext(
                a=torch.cat([merged.a, tail.a]), b=torch.cat([merged.b, tail.b]),
                current_variance=torch.cat([merged.current_variance,
                                            tail.current_variance]))
        eqs = merged
        m = half + m % 2
    return lwe_index(eqs, 0)


def select_word(c: LweCiphertext, a_bits: LweCiphertext, b_bits: LweCiphertext,
                ek: EvalKey, params: GateBootstrappingParams) -> LweCiphertext:
    """Per-bit MUX c ? a : b over whole words: one batched MUX with the
    selector shared across the bit axis."""
    return gates.mux(_lwe_broadcast(c, a_bits.b.shape[0]), a_bits, b_bits, ek, params)
