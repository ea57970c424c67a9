"""The dp NAND on the eval key that FrameworkConfig prepares, against the
benchmark's plain reference.

A deployment calls ``FrameworkConfig.make_mesh()``, ``prepare_eval_key``
and the sharded NAND, so every rank bootstraps its dp slice through the
configured form: "ntt" (kernel K1; its plain version here).  Four gloo
ranks on the CPU (``torch_parallel_worker.py``'s job ``parallel_form``) run
it at layouts (4, 1) and (2, 2) and at halfBg = 128 and 512 (a set that the
compact rows refuse); the cloud key reaches ranks 1-3 from rank 0 through
``mesh.replicate``.  Each gathered output is held word for word against
``benchmark/reference``'s NAND of the whole batch (plain torch, float64
exact), and against rank 0's and the one-card gate's, variance rail too.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.reference import gates as G  # noqa: E402
from benchmark.reference import tfhe as ref  # noqa: E402
from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, lwe, params  # noqa: E402
from eoc_tfhe_tpu_torch.parallel import mesh, sharded  # noqa: E402
from torch_parallel_worker import run_ranks  # noqa: E402

WORLD = 4
BATCH = 8
#: set name -> Bgbit of ``params.test_params``: halfBg 128 and 512
SETS = {"h128": 8, "h512": 10}
LAYOUTS = ("4x1", "2x2")


def _ref_params(Bgbit: int) -> ref.Params:
    p = params.test_params(Bgbit=Bgbit)
    tl, tg = p.tgsw_params.tlwe_params, p.tgsw_params
    return ref.Params(n=p.n, N=tl.N, k=tl.k, l=tg.l, Bgbit=tg.Bgbit, ks_t=p.ks.t,
                      ks_basebit=p.ks.basebit, ks_stdev=p.in_out_params.alpha_min,
                      bk_stdev=tl.alpha_min, max_stdev=tl.alpha_max)


@pytest.fixture(scope="module")
def case():
    """Per set: the reference's keyset, a batch of encrypted bit pairs and
    the reference's NAND of the whole batch; the inputs of the ranks."""
    inputs, want = {"sets": np.array(list(SETS))}, {}
    for s, Bgbit in SETS.items():
        p = _ref_params(Bgbit)
        gen = torch.Generator().manual_seed(1900 + Bgbit)
        k = ref.keygen(gen, p)
        bits = torch.randint(0, 2, (2, BATCH), generator=gen).bool()
        cts = [ref.encrypt(gen, torch.where(x, ref.MU, -ref.MU).to(torch.int32), k.lwe,
                           p.ks_stdev) for x in bits]
        var = np.full(BATCH, np.float32(p.ks_stdev) ** 2, np.float32)
        inputs.update({f"{s}_Bgbit": np.array(Bgbit), f"{s}_lwe": k.lwe.numpy(),
                       f"{s}_ring": k.ring.numpy(), f"{s}_bk": k.bk.numpy(),
                       f"{s}_bk_var": np.float32(p.bk_stdev) ** 2, f"{s}_ks": k.ks.numpy(),
                       f"{s}_ks_var": np.float32(p.ks_stdev) ** 2})
        for name, (a, b) in zip(("ca", "cb"), cts):
            inputs.update({f"{s}_{name}_a": a.numpy(), f"{s}_{name}_b": b.numpy(),
                           f"{s}_{name}_var": var})
        wa, wb = G.Gates(k, p).gate("nand", *[(x.to(torch.int64) & ref.MASK32,
                                               y.to(torch.int64) & ref.MASK32) for x, y in cts])
        want[s] = dict(a=wa.numpy(), b=wb.numpy(), bits=(~(bits[0] & bits[1])).numpy(),
                       lwe=k.lwe)
    return dict(inputs=inputs, want=want)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    return run_ranks("parallel_form", WORLD, tmp_path_factory.mktemp("parallel_form"),
                     case["inputs"])


def _words(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int64) & ref.MASK32


@pytest.mark.parametrize("halfbg", sorted(SETS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_dp_nand_on_eval_key_matches_reference(ranks, case, layout, halfbg):
    """Every rank's whole gathered output: the reference's words, rank 0's
    words and variances, the one-card gate's, and the plaintext NAND."""
    want = case["want"][halfbg]
    key = f"{halfbg}_{layout}"
    for out in ranks:
        assert str(out[f"{halfbg}_form"]) == "ntt_kernel"
        np.testing.assert_array_equal(_words(out[f"{key}_a"]), want["a"])
        np.testing.assert_array_equal(_words(out[f"{key}_b"]), want["b"])
        for f in ("a", "b", "var"):
            np.testing.assert_array_equal(out[f"{key}_{f}"], ranks[0][f"{key}_{f}"])
            np.testing.assert_array_equal(out[f"{key}_{f}"], ranks[0][f"{halfbg}_one_{f}"])
    got = ref.decrypt_bits(torch.from_numpy(out[f"{key}_a"]), torch.from_numpy(out[f"{key}_b"]),
                           want["lwe"])
    np.testing.assert_array_equal(got.numpy(), want["bits"])


def test_dp_nand_spans_and_collective_bytes(ranks):
    """Under a profiler each rank opens its input and gather spans, the mesh
    collective's span, and K1's rotate span (never the compact form's); the
    gather hands on this rank's slice: (2, 16) + 2 int32 words + 2 float32
    variances = 144 bytes, which ``collective_bytes`` counts."""
    for r, out in enumerate(ranks):
        spans = set(out["spans"].tolist())
        assert {f"tfhe.parallel.inputs dp=4 rank={r}", "tfhe.parallel.gather dp=4 bytes=144",
                "tfhe.mesh.all_gather axis=dp bytes=128", "tfhe.mesh.all_gather axis=dp bytes=8",
                "tfhe.bootstrap.rotate B=2 form=ntt_kernel", "tfhe.keyswitch"} <= spans, spans
        assert not [s for s in spans if "compact" in s]
        assert int(out["collective_bytes"]) == 144


def _one_rank(Bgbit: int):
    p = params.test_params(Bgbit=Bgbit)
    gen = torch.Generator().manual_seed(Bgbit)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p, device="cpu")
    bits = torch.tensor([0, 0, 1, 1], dtype=torch.bool), torch.tensor([0, 1, 0, 1],
                                                                      dtype=torch.bool)
    ca, cb = (gates.encrypt_bit(gen, x, ks.lwe_key, p) for x in bits)
    args = (ca.a, ca.b, ca.current_variance, cb.a, cb.b, cb.current_variance)
    return p, ks, args, mesh.make_mesh(device="cpu")


def test_compact_rows_refused_at_halfbg_512_eval_key_taken():
    """The rows call refuses halfBg = 512 (the rows' int8 digits); the eval
    key of the same set goes through K1's form and equals the one-card NAND."""
    p, ks, args, m = _one_rank(10)
    fn = sharded.make_sharded_nand(m, p)
    ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    with pytest.raises(ValueError, match="halfBg"):
        fn(*args, ks.cloud.bk.bk, ek.bk_variance, ek.ks_prepared, ks.cloud.bk.ks.variance)
    with pytest.raises(ValueError, match="pass it alone"):
        fn(*args, ek, ek.bk_variance)
    got = fn(*args, ek)
    one = gates.nand(lwe.LweCiphertext(*args[:3]), lwe.LweCiphertext(*args[3:]), ek, p)
    for g, w in zip(got, (one.a, one.b, one.current_variance)):
        assert torch.equal(g, w)


def test_dp_gate_spans_only_under_a_profiler(monkeypatch):
    """With no profiler recording no span is opened (record_function is
    never called); under one the gate opens ``tfhe.parallel.gather`` with
    its bytes: (4, 16) + 4 int32 words + 4 float32 variances."""
    from torch.profiler import ProfilerActivity, profile

    p, ks, args, m = _one_rank(8)
    fn = sharded.make_sharded_nand(m, p)
    ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: opened.append(name) or real(name, *a))
    fn(*args, ek)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args, ek)
    names = {e.name for e in prof.events()}
    assert "tfhe.parallel.gather dp=1 bytes=288" in names, names
    assert "tfhe.parallel.inputs dp=1 rank=0" in names
    assert any(n.startswith("tfhe.parallel.gather") for n in opened)
