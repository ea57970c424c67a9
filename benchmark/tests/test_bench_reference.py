"""The benchmark's reference against the port's plain path (the CPU
versions of the kernels), word for word, at small parameter sets: the
gates, MUX, the uint8 circuits behind the string API with the record
codec, and the key hand-over."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import codec, gates as G, tfhe as ref
from benchmark.tests.conftest import TINY_PARAMS

#: the tiny set, and one with halfBg > 128 as at the 80-bit set (K1's
#: two-digit-limb path, l = 2, Bgbit = 10)
SETS = {"tiny": TINY_PARAMS, "wide-digits": dict(TINY_PARAMS, bk_Bgbit=10, ks_t=15,
                                                 ks_basebit=1)}


def _port(p: ref.Params):
    from benchmark.harness import port_params
    return port_params(p)


@pytest.fixture(scope="module", params=sorted(SETS))
def setup(request):
    from benchmark.harness import port_keyset, framework_config

    p = ref.Params.from_config(SETS[request.param])
    gen = torch.Generator().manual_seed(11)
    keys = ref.keygen(gen, p)
    keyset = port_keyset(keys, p, "cpu")
    ek = framework_config({"framework": {"eval_key_form": "ntt"}}).prepare_eval_key(
        keyset.cloud, _port(p))
    return p, gen, keys, keyset, ek


def _enc(gen, bits, keys, p):
    mu = torch.where(bits, ref.MU, -ref.MU).to(torch.int32)
    return ref.encrypt(gen, mu, keys.lwe, p.ks_stdev)


def _words(ct):
    return ct[0].to(torch.int64) & ref.MASK32, ct[1].to(torch.int64) & ref.MASK32


@pytest.mark.parametrize("kind", sorted(G.LINEAR) + ["mux"])
def test_gates_word_for_word(setup, kind):
    from eoc_tfhe_tpu_torch.core import gates
    from eoc_tfhe_tpu_torch.core.lwe import LweCiphertext

    p, gen, keys, _, ek = setup
    arity = 3 if kind == "mux" else 2
    bits = torch.randint(0, 2, (arity, 24), generator=gen).bool()
    cts = [_enc(gen, bits[j], keys, p) for j in range(arity)]
    port = [LweCiphertext(a, b, torch.zeros(b.shape)) for a, b in cts]
    out = getattr(gates, kind)(*port, ek, _port(p))
    g = G.Gates(keys, p)
    ra, rb = (g.mux if kind == "mux" else lambda *o: g.gate(kind, *o))(*map(_words, cts))
    assert torch.equal(ref.wrap(ra), out.a) and torch.equal(ref.wrap(rb), out.b)
    assert torch.equal(ref.decrypt_bits(out.a, out.b, keys.lwe), G.PLAIN[kind](*bits))


def test_control_differs(setup):
    """The float32 control gives other words than the exact product."""
    p, gen, keys, _, _ = setup
    bits = torch.randint(0, 2, (2, 16), generator=gen).bool()
    cts = [_words(_enc(gen, bits[j], keys, p)) for j in range(2)]
    exact = G.Gates(keys, p).gate("nand", *cts)
    low = G.Gates(keys, p, torch.float32).gate("nand", *cts)
    assert not torch.equal(exact[0], low[0])


@pytest.mark.parametrize("op", sorted(G.PLAIN_U8))
def test_uint8_calls_word_for_word(setup, op):
    """The session's uint8 calls on records the reference codec wrote, word
    for word and value for value against the reference's circuits."""
    from eoc_tfhe_tpu_torch.api.tfhe import TfheSession
    from benchmark.harness import framework_config

    p, gen, keys, _, _ = setup
    session = TfheSession(params=_port(p), seed=3, device="cpu",
                          config=framework_config({"framework": {"eval_key_form": "ntt"}}))
    session.import_secret_key(codec.b64encode(codec.secret_keyset(
        p, keys.lwe.numpy(), keys.ring.numpy(), keys.bk.numpy(), keys.ks.numpy())))
    assert torch.equal(session.keyset.cloud.bk.bk, keys.bk)
    assert torch.equal(session.keyset.cloud.bk.ks.ks, keys.ks)
    vals = [int(v) for v in torch.randint(0, 256, (2,), generator=gen)]
    cts = []
    for v in vals:
        a, b = _enc(gen, torch.tensor([(v >> i) & 1 for i in range(8)]).bool(), keys, p)
        cts.append((a, b, codec.b64encode(codec.pack_samples(a.numpy(), b.numpy(), 1e-9))))
    method = {"add": "add_uint8_bits", "sub": "subtract_uint8_bits"}[op]
    out = getattr(session, method)(*(c[2] for c in cts))
    a, b = codec.unpack_samples(codec.b64decode(out), 8, p.n)
    ops = [(_words((c[0], c[1]))[0][:, None], _words((c[0], c[1]))[1][:, None]) for c in cts]
    ra, rb = getattr(G.Gates(keys, p), op)(*ops)
    assert np.array_equal(ref.wrap(ra[:, 0]).numpy(), a)
    assert np.array_equal(ref.wrap(rb[:, 0]).numpy(), b)
    bits = ref.decrypt_bits(torch.from_numpy(a), torch.from_numpy(b), keys.lwe)
    assert sum(int(x) << i for i, x in enumerate(bits)) == G.PLAIN_U8[op](*vals)


def test_keyset_hand_over(setup):
    p, _, keys, keyset, _ = setup
    assert torch.equal(keyset.cloud.bk.bk, keys.bk) and torch.equal(keyset.cloud.bk.ks.ks, keys.ks)
    assert torch.equal(keyset.lwe_key.s, keys.lwe) and torch.equal(keyset.tgsw_key.key, keys.ring)
