"""Plain gates and uint8 circuits over :mod:`.tfhe`, and their plaintext
counterparts.

A ciphertext is a pair (a (..., n), b (...)) of int64 torus words in
[0, 2^32).  The gates follow upstream ``boot-gates.cpp``: a two-input gate
bootstraps (0, offset) + sa*ca + sb*cb with mu = 1/8; MUX bootstraps twice
without key switching, adds the two and switches once.  MAJ and the
refresh bootstrap a + b + c and the sample itself.  The uint8 circuits
are the string API's addition and subtraction, gate by gate: the
carry-save ripple adder (one MAJ a bit, the sum bit a linear combination,
one refresh of all sum bits) and its borrow form.  Each circuit takes and
gives bits on a leading axis of 8, least significant first.
"""

from __future__ import annotations

import torch

from . import tfhe
from .tfhe import MASK32, MU, t32

#: kind: (offset numerator, offset denominator, sa, sb) of upstream's gates.
LINEAR = {"nand": (1, 8, -1, -1), "and_": (-1, 8, 1, 1), "or_": (1, 8, 1, 1),
          "nor": (-1, 8, -1, -1), "xor_": (1, 4, 2, 2), "xnor": (-1, 4, -2, -2),
          "andny": (-1, 8, -1, 1), "andyn": (-1, 8, 1, -1), "orny": (1, 8, -1, 1),
          "oryn": (1, 8, 1, -1)}

#: The plaintext of each gate kind, on bool tensors (mux: c ? x : y).
PLAIN = {"nand": lambda x, y: ~(x & y), "and_": lambda x, y: x & y,
         "or_": lambda x, y: x | y, "nor": lambda x, y: ~(x | y),
         "xor_": lambda x, y: x ^ y, "xnor": lambda x, y: ~(x ^ y),
         "andny": lambda x, y: ~x & y, "andyn": lambda x, y: x & ~y,
         "orny": lambda x, y: ~x | y, "oryn": lambda x, y: x | ~y,
         "mux": lambda c, x, y: torch.where(c, x, y)}

#: The plaintext of each uint8 operation of the string API.
PLAIN_U8 = {"add": lambda x, y: (x + y) % 256, "sub": lambda x, y: (x - y) % 256}


class Gates:
    """Bootstrapped gates under one keyset; ``dtype`` float64 is exact,
    float32 is the control."""

    def __init__(self, keys: tfhe.Keys, p: tfhe.Params, dtype=torch.float64):
        self.keys, self.p = keys, p
        self.ev = tfhe.Evaluator(keys, p, dtype)

    def linear(self, offset: int, *terms):
        """(0, offset) + sum of c * ct over (c, ct) terms."""
        a = sum(c * ct[0] for c, ct in terms)
        b = offset + sum(c * ct[1] for c, ct in terms)
        return a & MASK32, b & MASK32

    def _flat(self, fn, ct):
        shape = tuple(ct[1].shape)
        a, b = fn(ct[0].reshape(-1, ct[0].shape[-1]), ct[1].reshape(-1))
        return a.reshape(shape + (a.shape[-1],)), b.reshape(shape)

    def bootstrap(self, ct):
        def run(a, b):
            oa, ob = self.ev.bootstrap(MU, a, b)
            return oa.to(torch.int64) & MASK32, ob.to(torch.int64) & MASK32
        return self._flat(run, ct)

    def bootstrap_wo_ks(self, ct):
        return self._flat(lambda a, b: self.ev.bootstrap_wo_ks(MU, a, b), ct)

    def keyswitch(self, ct):
        def run(a, b):
            oa, ob = self.ev.keyswitch(a, b)
            return oa.to(torch.int64) & MASK32, ob.to(torch.int64) & MASK32
        return self._flat(run, ct)

    def gate(self, kind: str, x, y):
        num, den, sa, sb = LINEAR[kind]
        return self.bootstrap(self.linear(t32(num, den), (sa, x), (sb, y)))

    def mux(self, c, x, y):
        u1 = self.bootstrap_wo_ks(self.linear(t32(-1, 8), (1, c), (1, x)))
        u2 = self.bootstrap_wo_ks(self.linear(t32(-1, 8), (1, y), (-1, c)))
        return self.keyswitch(self.linear(t32(1, 8), (1, u1), (1, u2)))

    def maj(self, x, y, z):
        return self.bootstrap(self.linear(0, (1, x), (1, y), (1, z)))

    def false(self, shape):
        """The trivial encryption of false: (0, -1/8)."""
        dev = self.keys.bk.device
        return (torch.zeros(tuple(shape) + (self.p.n,), dtype=torch.int64, device=dev),
                torch.full(tuple(shape), -MU & MASK32, dtype=torch.int64, device=dev))

    # -- uint8 circuits: bits (8, ...) -------------------------------------

    def add(self, x, y):
        carry, sums = self.false(x[1].shape[1:]), []
        for i in range(8):
            xi, yi = _bit(x, i), _bit(y, i)
            cout = self.maj(xi, yi, carry)
            sums.append(self.linear(0, (1, xi), (1, yi), (1, carry), (-2, cout)))
            carry = cout
        return self.bootstrap(_stack(sums))

    def sub(self, x, y):
        borrow, diffs = self.false(x[1].shape[1:]), []
        for i in range(8):
            u, yi = _neg(_bit(x, i)), _bit(y, i)
            bout = self.maj(u, yi, borrow)
            diffs.append(self.linear(0, (-1, u), (-1, yi), (-1, borrow), (2, bout)))
            borrow = bout
        return self.bootstrap(_stack(diffs))


def _bit(ct, i):
    return ct[0][i], ct[1][i]


def _neg(ct):
    return (-ct[0]) & MASK32, (-ct[1]) & MASK32


def _stack(cts):
    return torch.stack([c[0] for c in cts]), torch.stack([c[1] for c in cts])

