"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (the kernels have no CPU or interpret mode) and
skip without one. They import only the port, so they also run where JAX is
absent:  python -m pytest --noconftest tests/test_torch_card.py -q
"""

import base64
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, lwe, params
from eoc_tfhe_tpu_torch.kernels import build
from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact, blind_rotate_v1, ntt

CASES = {
    "toy": lambda: params.test_params(n=16, N=64, k=1, l=3, Bgbit=7),
    "bgbit10": lambda: params.test_params(n=8, N=64, k=1, l=2, Bgbit=10),
    "full_width_8_steps": lambda: params.default_128bit_params(),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_the_card(case, cuda_device):
    p = CASES[case]()
    n_steps, B = min(p.n, 8), 5                # odd B: a block with one sample
    tg = p.tgsw_params
    N, U = tg.tlwe_params.N, tg.tlwe_params.k + 1
    gen = torch.Generator(device=cuda_device).manual_seed(4)

    def i32(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                             device=cuda_device).to(torch.int32)
    rows, acc0 = i32((n_steps, tg.kpl, U, N)), i32((B, U, N))
    bara = torch.randint(0, 2 * N, (n_steps, B), generator=gen, dtype=torch.int32,
                         device=cuda_device)
    ctx = ntt.kernel_context_for_params(p, device=cuda_device)
    key = ntt.prepare_kernel_key(rows, ctx)
    before = blind_rotate.launches
    out = blind_rotate.blind_rotate_ntt(acc0, bara, key, ctx, p)
    torch.cuda.synchronize()
    assert blind_rotate.launches == before + 1
    assert torch.equal(out, blind_rotate.blind_rotate_ntt_plain(acc0, bara, key, ctx, p))


@pytest.mark.gpu
def test_nand_on_the_card_goes_through_the_kernel(cuda_device):
    p = CASES["toy"]()
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p)
    ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    a = torch.randint(0, 2, (33,), generator=gen, device=cuda_device).bool()
    b = torch.randint(0, 2, (33,), generator=gen, device=cuda_device).bool()
    ca = gates.encrypt_bit(gen, a, ks.lwe_key, p)
    cb = gates.encrypt_bit(gen, b, ks.lwe_key, p)
    before = blind_rotate.launches
    out = gates.nand(ca, cb, ek, p)
    assert blind_rotate.launches == before + 1
    assert torch.equal(gates.decrypt_bit(out, ks.lwe_key), ~(a & b))


@pytest.mark.gpu
@pytest.mark.parametrize("primes", [ntt.DEFAULT_PRIMES, ntt.KERNEL_PRIMES])
@pytest.mark.parametrize("case", list(CASES))
def test_v1_kernel_matches_plain_on_the_card(case, primes, cuda_device):
    p = CASES[case]()
    n_steps, B = min(p.n, 8), 5                # odd B: a block with one sample
    tg = p.tgsw_params
    N, U = tg.tlwe_params.N, tg.tlwe_params.k + 1
    gen = torch.Generator(device=cuda_device).manual_seed(8)

    def i32(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                             device=cuda_device).to(torch.int32)
    rows, acc0 = i32((n_steps, tg.kpl, U, N)), i32((B, U, N))
    bara = torch.randint(0, 2 * N, (n_steps, B), generator=gen, dtype=torch.int32,
                         device=cuda_device)
    ctx = ntt.make_context(N, tg.kpl, tg.halfBg, primes, device=cuda_device)
    key = ntt.prepare_key_ntt(rows, ctx)
    before = blind_rotate_v1.launches
    out = blind_rotate_v1.blind_rotate_ntt_v1(acc0, bara, key, ctx, p)
    torch.cuda.synchronize()
    assert blind_rotate_v1.launches == before + 1
    assert torch.equal(out, blind_rotate_v1.blind_rotate_ntt_v1_plain(acc0, bara, key, ctx, p))


@pytest.mark.gpu
def test_nand_over_the_scan_key_goes_through_the_v1_kernel(cuda_device):
    p = CASES["bgbit10"]()
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p)
    ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p, kernel=False)
    assert ek.form == "ntt_scan"
    a = torch.randint(0, 2, (33,), generator=gen, device=cuda_device).bool()
    b = torch.randint(0, 2, (33,), generator=gen, device=cuda_device).bool()
    ca = gates.encrypt_bit(gen, a, ks.lwe_key, p)
    cb = gates.encrypt_bit(gen, b, ks.lwe_key, p)
    before = (blind_rotate_v1.launches, blind_rotate.launches)
    out = gates.nand(ca, cb, ek, p)
    assert (blind_rotate_v1.launches, blind_rotate.launches) == (before[0] + 1, before[1])
    assert torch.equal(gates.decrypt_bit(out, ks.lwe_key), ~(a & b))


COMPACT_CASES = {
    "toy": lambda: params.test_params(n=16, N=64, k=1, l=3, Bgbit=7),
    "bgbit8": lambda: params.test_params(n=8, N=64, k=1, l=2, Bgbit=8),
    "full_width_8_steps": lambda: params.default_128bit_params(),
}


@pytest.mark.gpu
@pytest.mark.parametrize("limbs", [4, 3])
@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compact_kernel_matches_plain_on_the_card(case, limbs, cuda_device):
    p = COMPACT_CASES[case]()
    n_steps, B = min(p.n, 8), 5                # odd B: a block with one live sample
    tg = p.tgsw_params
    N, U = tg.tlwe_params.N, tg.tlwe_params.k + 1
    gen = torch.Generator(device=cuda_device).manual_seed(6)

    def i32(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                             device=cuda_device).to(torch.int32)
    rows, acc0 = i32((n_steps, tg.kpl, U, N)), i32((B, U, N))
    bara = torch.randint(0, 2 * N, (n_steps, B), generator=gen, dtype=torch.int32,
                         device=cuda_device)
    key = blind_rotate_compact.prepare_compact_bk(rows, limbs)
    before = blind_rotate_compact.launches
    out = blind_rotate_compact.blind_rotate_compact(acc0, bara, key, p)
    torch.cuda.synchronize()
    assert blind_rotate_compact.launches == before + 1
    assert torch.equal(out, blind_rotate_compact.blind_rotate_compact_plain(acc0, bara, key, p))
    if limbs == 4:          # tfhe_blindRotate over the true rows takes the same kernel
        assert torch.equal(bootstrap.blind_rotate(acc0, bara.t(), rows, p), out)
        assert blind_rotate_compact.launches == before + 2


#: Batches that do not fill a block (8 samples), and the circuit path's batch.
RAGGED = [1, 7, 63, 1024]
K1_CASES = {**CASES, "80bit_8_steps": lambda: params.default_80bit_params()}


def _rotation_inputs(p, B, seed, device):
    n_steps = min(p.n, 8)
    tg = p.tgsw_params
    N, U = tg.tlwe_params.N, tg.tlwe_params.k + 1
    gen = torch.Generator(device=device).manual_seed(seed)

    def i32(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                             device=device).to(torch.int32)
    bara = torch.randint(0, 2 * N, (n_steps, B), generator=gen, dtype=torch.int32, device=device)
    return i32((n_steps, tg.kpl, U, N)), i32((B, U, N)), bara


@pytest.mark.gpu
@pytest.mark.parametrize("B", RAGGED)
@pytest.mark.parametrize("case", list(K1_CASES))
def test_ntt_kernel_matches_plain_at_ragged_batches(case, B, cuda_device):
    p = K1_CASES[case]()
    rows, acc0, bara = _rotation_inputs(p, B, 10 + B, cuda_device)
    ctx = ntt.kernel_context_for_params(p, device=cuda_device)
    key = ntt.prepare_kernel_key(rows, ctx)
    before = blind_rotate.launches
    out = blind_rotate.blind_rotate_ntt(acc0, bara, key, ctx, p)
    torch.cuda.synchronize()
    assert blind_rotate.launches == before + 1
    assert torch.equal(out, blind_rotate.blind_rotate_ntt_plain(acc0, bara, key, ctx, p))


#: Batches around K1's narrow tier: one sample group (B <= 8), two (9, 16),
#: and 16 groups (128), which the shipped sets' plan leaves to one block each.
NARROW_BATCHES = [1, 2, 5, 8, 9, 16, 128]


@pytest.mark.gpu
@pytest.mark.parametrize("B", NARROW_BATCHES)
@pytest.mark.parametrize("case", list(CASES))
def test_ntt_kernel_takes_the_narrow_tier_where_the_plan_says(case, B, cuda_device):
    """K1 against its plain version at small batches; ``cluster_launches``
    moves, and the launch runs ``rotate_kernel_narrow``, exactly where the
    plan (with the card's SMs and cluster occupancy) takes the narrow tier."""
    p = CASES[case]()
    tg = p.tgsw_params
    rows, acc0, bara = _rotation_inputs(p, B, 81, cuda_device)
    ctx = ntt.kernel_context_for_params(p, device=cuda_device)
    key = ntt.prepare_kernel_key(rows, ctx)
    samples, general, cluster = blind_rotate.launch_plan(B, tg.tlwe_params.k + 1, ctx, tg,
                                                         cuda_device)
    narrow = cluster > 1 and not general
    before = blind_rotate.launches, blind_rotate.cluster_launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = blind_rotate.blind_rotate_ntt(acc0, bara, key, ctx, p)
        torch.cuda.synchronize()
    assert (blind_rotate.launches, blind_rotate.cluster_launches) == (before[0] + 1,
                                                                      before[1] + narrow)
    kernels = [e.key for e in prof.key_averages() if "rotate_kernel" in e.key]
    assert len(kernels) == 1 and ("rotate_kernel_narrow" in kernels[0]) == narrow, kernels
    assert torch.equal(out, blind_rotate.blind_rotate_ntt_plain(acc0, bara, key, ctx, p))


#: Launches a case of the exchange's stress test, back to back, and the steps
#: of each (every step crosses the cluster twice).
STRESS_LAUNCHES, STRESS_STEPS = 64, 32


@pytest.mark.gpu
@pytest.mark.parametrize("alongside", [False, True])
@pytest.mark.parametrize("B", [1, 2, 5, 8])
@pytest.mark.parametrize("bits", ["128", "80"])
def test_narrow_tier_exchange_holds_under_skew(bits, B, alongside, cuda_device):
    """The narrow tier hands each step's accumulator and chat from block to
    block on mbarriers, with no cluster barrier in the step, so a race would
    show only under timing skew: 64 launches back to back at batch B, each
    with its own accumulator and bara, and (``alongside``) a B = 8192 launch
    of the shipped kernel over the same key on a second stream, queued
    first, so that the clusters start while its blocks hold the SMs. Every
    output equals the plain version's, bit for bit."""
    p = params.default_128bit_params() if bits == "128" else params.default_80bit_params()
    tg = p.tgsw_params
    N, U, n = tg.tlwe_params.N, tg.tlwe_params.k + 1, STRESS_STEPS
    gen = torch.Generator(device=cuda_device).manual_seed(300 + 10 * B + alongside)

    def i32(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                             device=cuda_device).to(torch.int32)

    def bara(*batch):
        return torch.randint(0, 2 * N, (*batch[:-1], n, batch[-1]), generator=gen,
                             dtype=torch.int32, device=cuda_device)
    ctx = ntt.kernel_context_for_params(p, device=cuda_device)
    key = ntt.prepare_kernel_key(i32((n, tg.kpl, U, N)), ctx)
    assert blind_rotate.launch_plan(B, U, ctx, tg, cuda_device)[1:] == (False, 16)
    acc0, baras = i32((STRESS_LAUNCHES, B, U, N)), bara(STRESS_LAUNCHES, B)
    if alongside:
        big_acc, big_bara = i32((8192, U, N)), bara(8192)
        side = torch.cuda.Stream(device=cuda_device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            big = blind_rotate.blind_rotate_ntt(big_acc, big_bara, key, ctx, p)
    before = blind_rotate.cluster_launches
    outs = [blind_rotate.blind_rotate_ntt(acc0[j], baras[j], key, ctx, p)
            for j in range(STRESS_LAUNCHES)]
    torch.cuda.synchronize()
    assert blind_rotate.cluster_launches == before + STRESS_LAUNCHES
    # one plain rotation over every launch's samples (each sample rotates alone)
    want = blind_rotate.blind_rotate_ntt_plain(acc0.reshape(-1, U, N),
                                               baras.transpose(0, 1).reshape(n, -1), key, ctx, p)
    assert torch.equal(torch.stack(outs).reshape(-1, U, N), want)
    if alongside:
        assert torch.equal(big, blind_rotate.blind_rotate_ntt_plain(big_acc, big_bara, key,
                                                                    ctx, p))


@pytest.mark.gpu
def test_uint8_add_and_subtract_at_batch_1_take_the_narrow_tier(cuda_device):
    """``addUint8`` and ``subtractUint8`` of the 128-bit API at batch 1:
    every rotation of the two calls takes the narrow tier, each rotate span
    says so (``C=16``), and the decoded values are the plaintext sum and
    difference mod 256."""
    from eoc_tfhe_tpu_torch.api.tfhe import Tfhe

    t = Tfhe(seed=12)
    t.generateSecretKey()
    a, b = t.encryptUint8(200), t.encryptUint8Seeded(77)
    before = blind_rotate.launches, blind_rotate.cluster_launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        total, diff = t.addUint8(a, b), t.subtractUint8(a, b)
    runs = blind_rotate.launches - before[0]
    assert runs > 0 and blind_rotate.cluster_launches - before[1] == runs
    spans = [e.name for e in prof.events() if e.name.startswith("tfhe.bootstrap.rotate")]
    assert len(spans) == runs and all(n.endswith(" form=ntt_kernel C=16") for n in spans), spans
    assert (t.decryptUint8(total), t.decryptUint8(diff)) == (277 % 256, 200 - 77)


@pytest.mark.gpu
def test_gate_path_queues_without_a_host_wait(cuda_device, monkeypatch):
    """On a warmed 128-bit key, ``addUint8`` and ``subtractUint8`` at batch 1
    and a NAND at B = 64 make no synchronizing call between the operands'
    upload and the export: ``torch.cuda.set_sync_debug_mode("error")`` is on
    over that stretch (a pageable host-to-device copy or a stream wait
    raises), and the outputs decrypt to the plaintext results."""
    from eoc_tfhe_tpu_torch.api.tfhe import Tfhe

    t = Tfhe(seed=14)
    t.generateSecretKey()
    s = t._s
    a, b = t.encryptUint8(200), t.encryptUint8(77)
    t.addUint8(a, b), t.subtractUint8(a, b)                 # warm: the key's first calls
    import_bits, export_samples, imported = s._import_bits, s._export_samples, []

    def import_then_guard(blob):
        ct = import_bits(blob)
        imported.append(ct)
        if len(imported) % 2 == 0:                          # both operands uploaded
            torch.cuda.set_sync_debug_mode("error")
        return ct

    def unguard_then_export(ct):
        torch.cuda.set_sync_debug_mode("default")
        return export_samples(ct)

    monkeypatch.setattr(s, "_import_bits", import_then_guard)
    monkeypatch.setattr(s, "_export_samples", unguard_then_export)
    try:
        total, diff = t.addUint8(a, b), t.subtractUint8(a, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(imported) == 4
    monkeypatch.undo()
    assert (t.decryptUint8(total), t.decryptUint8(diff)) == (277 % 256, 200 - 77)

    api, gen = s.gate_api(), torch.Generator(device=cuda_device).manual_seed(15)
    x, y = (torch.randint(0, 2, (64,), generator=gen, device=cuda_device).bool()
            for _ in range(2))
    cx, cy = (gates.encrypt_bit(gen, v, s.keyset.lwe_key, api.params) for v in (x, y))
    gates.nand(cx, cy, api.eval_key, api.params)            # warm: the shape's first call
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gates.nand(cx, cy, api.eval_key, api.params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(gates.decrypt_bit(out, s.keyset.lwe_key), ~(x & y))


@pytest.mark.gpu
@pytest.mark.parametrize("B", RAGGED)
@pytest.mark.parametrize("limbs", [4, 3])
@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compact_kernel_matches_plain_at_ragged_batches(case, limbs, B, cuda_device):
    p = COMPACT_CASES[case]()
    rows, acc0, bara = _rotation_inputs(p, B, 20 + B, cuda_device)
    key = blind_rotate_compact.prepare_compact_bk(rows, limbs)
    before = blind_rotate_compact.launches
    out = blind_rotate_compact.blind_rotate_compact(acc0, bara, key, p)
    torch.cuda.synchronize()
    assert blind_rotate_compact.launches == before + 1
    assert torch.equal(out, blind_rotate_compact.blind_rotate_compact_plain(acc0, bara, key, p))


@pytest.mark.gpu
def test_maj_and_refresh_on_the_card_go_through_the_compact_kernel(cuda_device):
    p = params.test_params()
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p)
    ek = bootstrap.prepare_eval_key_fused(ks.cloud, p)
    bits = torch.randint(0, 2, (3, 9), generator=gen, device=cuda_device).bool()
    ca, cb, cc = (gates.encrypt_bit(gen, x, ks.lwe_key, p) for x in bits)
    before = blind_rotate_compact.launches
    out = gates.maj(ca, cb, cc, ek, p)
    assert blind_rotate_compact.launches == before + 1
    assert torch.equal(gates.decrypt_bit(out, ks.lwe_key), bits.sum(0) >= 2)
    out = gates.refresh(gates.not_(ca), ek, p)
    assert blind_rotate_compact.launches == before + 2
    assert torch.equal(gates.decrypt_bit(out, ks.lwe_key), ~bits[0])


@pytest.mark.gpu
@pytest.mark.parametrize("B", RAGGED)
@pytest.mark.parametrize("primes", [ntt.DEFAULT_PRIMES, ntt.KERNEL_PRIMES])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_v1_kernel_matches_plain_at_ragged_batches(case, primes, B, cuda_device):
    p = K1_CASES[case]()
    tg = p.tgsw_params
    rows, acc0, bara = _rotation_inputs(p, B, 30 + B, cuda_device)
    ctx = ntt.make_context(tg.tlwe_params.N, tg.kpl, tg.halfBg, primes, device=cuda_device)
    key = ntt.prepare_key_ntt(rows, ctx)
    before = blind_rotate_v1.launches
    out = blind_rotate_v1.blind_rotate_ntt_v1(acc0, bara, key, ctx, p)
    torch.cuda.synchronize()
    assert blind_rotate_v1.launches == before + 1
    assert torch.equal(out, blind_rotate_v1.blind_rotate_ntt_v1_plain(acc0, bara, key, ctx, p))


#: ROADMAP C5: k = 2 (U*R = 24, M = 72), K = 64, and N = 128; and N = 32
#: (R = 4: U*R = 8, M = 24; K2 at 4 warps of one tile each).
C5_CASES = {
    "k2_l2_N64": lambda: params.test_params(k=2, l=2, N=64, n=4),
    "k1_l4_N64": lambda: params.test_params(k=1, l=4, N=64),
    "k1_l2_N128": lambda: params.test_params(k=1, l=2, N=128),
    "k1_l2_N32": lambda: params.test_params(k=1, l=2, N=32),
}


def _shape_rotation(kernel, p, device, B=7):
    """The kernel's wrapper and plain version and their inputs at (p, B)."""
    tg = p.tgsw_params
    rows, acc0, bara = _rotation_inputs(p, B, 40 + B, device)
    if kernel == "K1":
        ctx = ntt.kernel_context_for_params(p, device=device)
        key = ntt.prepare_kernel_key(rows, ctx)
        return (blind_rotate, lambda: blind_rotate.blind_rotate_ntt(acc0, bara, key, ctx, p),
                lambda: blind_rotate.blind_rotate_ntt_plain(acc0, bara, key, ctx, p))
    if kernel == "K3":
        ctx = ntt.context_for_params(p, device=device)
        key = ntt.prepare_key_ntt(rows, ctx)
        return (blind_rotate_v1,
                lambda: blind_rotate_v1.blind_rotate_ntt_v1(acc0, bara, key, ctx, p),
                lambda: blind_rotate_v1.blind_rotate_ntt_v1_plain(acc0, bara, key, ctx, p))
    key = blind_rotate_compact.prepare_compact_bk(rows, 4)
    assert tg.halfBg <= 128
    return (blind_rotate_compact,
            lambda: blind_rotate_compact.blind_rotate_compact(acc0, bara, key, p),
            lambda: blind_rotate_compact.blind_rotate_compact_plain(acc0, bara, key, p))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
@pytest.mark.parametrize("case", list(C5_CASES))
def test_kernels_match_plain_at_the_c5_shapes(case, kernel, cuda_device):
    """Each kernel takes the C5 shapes (part A widened all three), bit for
    bit against its plain version."""
    module, run, plain = _shape_rotation(kernel, C5_CASES[case](), cuda_device)
    before = module.launches
    out = run()
    torch.cuda.synchronize()
    assert module.launches == before + 1
    assert torch.equal(out, plain())


#: ROADMAP C7: N = 2048 (F = 256), k = 2 at N = 1024 (K = 72), k = 3 (K = 96,
#: U = 4), l = 5 (K = 80), and halfBg = 512 at k = 2 (K1 and K3 only: C1).
C7_CASES = {
    "N2048_k1_l3": lambda: params.test_params(N=2048, k=1, l=3, Bgbit=7, n=8),
    "N1024_k2_l3": lambda: params.test_params(N=1024, k=2, l=3, Bgbit=7, n=8),
    "N512_k3_l3": lambda: params.test_params(N=512, k=3, l=3, Bgbit=6, n=8),
    "N1024_k1_l5": lambda: params.test_params(N=1024, k=1, l=5, Bgbit=5, n=8),
    "N1024_k2_l1_bg10": lambda: params.test_params(N=1024, k=2, l=1, Bgbit=10, n=8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("B", [7, 13])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
@pytest.mark.parametrize("case", list(C7_CASES))
def test_kernels_match_plain_at_the_c7_shapes(case, kernel, B, cuda_device):
    """Each kernel takes the C7 shapes (all 8 steps; B = 13 leaves a ragged
    last block at 8 and at 4 samples a block), bit for bit against its plain
    version; the compact form still refuses halfBg = 512 (C1)."""
    p = C7_CASES[case]()
    if kernel == "K2" and p.tgsw_params.halfBg > 128:
        with pytest.raises(ValueError, match="halfBg = 512 > 128"):
            blind_rotate_compact.check_kernel_domain(p)
        return
    module, run, plain = _shape_rotation(kernel, p, cuda_device, B)
    before = module.launches
    out = run()
    torch.cuda.synchronize()
    assert module.launches == before + 1
    assert torch.equal(out, plain())


#: ROADMAP C8: N = 4096 (F = 512; K3 and K2, no K1 context), k = 3 l = 5 (K
#: = 160), k = 4 (U = 5), k = 3 at N = 2048 (K2's row-share plan), K = 256
#: (k = 3 l = 8, k = 1 l = 16) and halfBg = 512 at F = 512 (K3 only: C1).
C8_CASES = {
    "N4096_k1_l3": lambda: params.test_params(N=4096, k=1, l=3, Bgbit=7, n=8),
    "N1024_k3_l5": lambda: params.test_params(N=1024, k=3, l=5, Bgbit=5, n=8),
    "N512_k4_l3": lambda: params.test_params(N=512, k=4, l=3, Bgbit=7, n=8),
    "N2048_k3_l3": lambda: params.test_params(N=2048, k=3, l=3, Bgbit=7, n=8),
    "N512_k3_l8_bg4": lambda: params.test_params(N=512, k=3, l=8, Bgbit=4, n=8),
    "N1024_k1_l16_bg2": lambda: params.test_params(N=1024, k=1, l=16, Bgbit=2, n=8),
    "N4096_k1_l1_bg10": lambda: params.test_params(N=4096, k=1, l=1, Bgbit=10, n=8),
}
#: ROADMAP C9: the rounded-key plans (rb = 2) on the register path (k = 1),
#: the scatter path (k = 2) and the general instantiation (k = 2 l = 3 over
#: DEFAULT_PRIMES; N = 4096), over the form's own prime pair.
C9_CASES = {
    "n8": lambda: params.test_params(n=8),
    "N128": lambda: params.test_params(N=128, n=8),
    "k2_l2_N64": lambda: params.test_params(k=2, l=2, N=64, n=8),
    "k2_l3_N64": lambda: params.test_params(k=2, l=3, N=64, n=8),
    "N4096_k1_l3": lambda: params.test_params(N=4096, k=1, l=3, Bgbit=7, n=8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("B", [7, 13])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
@pytest.mark.parametrize("case", list(C8_CASES))
def test_kernels_match_plain_at_the_c8_shapes(case, kernel, B, cuda_device):
    """Each kernel takes the C8 shapes (all 8 steps; B = 13 leaves a ragged
    last block), bit for bit against its plain version; where the shape has
    no K1 context (N = 4096) or halfBg > 128 (C1), the refusal is by name."""
    p = C8_CASES[case]()
    if kernel == "K1" and p.N == 4096:
        with pytest.raises(ValueError, match="K1 .* has no context at N=4096"):
            ntt.kernel_context_for_params(p, device=cuda_device)
        return
    if kernel == "K2" and p.tgsw_params.halfBg > 128:
        with pytest.raises(ValueError, match="halfBg = 512 > 128"):
            blind_rotate_compact.check_kernel_domain(p)
        return
    module, run, plain = _shape_rotation(kernel, p, cuda_device, B)
    before = module.launches
    out = run()
    torch.cuda.synchronize()
    assert module.launches == before + 1
    assert torch.equal(out, plain())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [7, 13])
@pytest.mark.parametrize("case,kernel", [(c, k) for c in C9_CASES for k in ("K1", "K3")
                                         if (c, k) != ("N4096_k1_l3", "K1")])
def test_kernels_match_plain_with_the_rounded_plans(case, kernel, B, cuda_device):
    """K1 and K3 over a rounded-key plan's key and context (the limbs shifted
    by rb + kbits l), bit for bit against the plain version (K1 has no
    context at N = 4096)."""
    p = C9_CASES[case]()
    tg = p.tgsw_params
    rows, acc0, bara = _rotation_inputs(p, B, 60 + B, cuda_device)
    if kernel == "K1":
        ctx = ntt.kernel_context_for_params(p, rounded=True, device=cuda_device)
        key, module = ntt.prepare_kernel_key(rows, ctx), blind_rotate
        run = lambda: blind_rotate.blind_rotate_ntt(acc0, bara, key, ctx, p)   # noqa: E731
        plain = lambda: blind_rotate.blind_rotate_ntt_plain(acc0, bara, key, ctx, p)   # noqa: E731
    else:
        ctx = ntt.context_for_params(p, rounded=True, device=cuda_device)
        key, module = ntt.prepare_key_ntt(rows, ctx), blind_rotate_v1
        run = lambda: blind_rotate_v1.blind_rotate_ntt_v1(acc0, bara, key, ctx, p)   # noqa: E731
        plain = lambda: blind_rotate_v1.blind_rotate_ntt_v1_plain(  # noqa: E731
            acc0, bara, key, ctx, p)
    assert ctx.key_round_bits == (0 if kernel == "K1" and case in ("N128", "k2_l3_N64")
                                  else 2), tg
    before = module.launches
    out = run()
    torch.cuda.synchronize()
    assert module.launches == before + 1
    assert torch.equal(out, plain())


#: ROADMAP C10: the shapes whose one sample overflows a block (N = 8192 and
#: 16384, F = 1024 and 2048: K3 in a cluster of 2 and 4 blocks, K2 at one
#: sample a block and in a cluster of 2; N = 4096 k = 2 l = 6, Kp = 144 at F
#: = 512: K3 in a cluster of 2), K = 288 (K1 and K3), U = 6 (K2's general
#: kernel, at N = 8192 in a cluster of 2), N = 16 and 8 (F = 4).  K1 has no
#: context at N >= 4096, as in the reference.
C10_CASES = {
    "N8192_k1_l3": lambda: params.test_params(N=8192, k=1, l=3, Bgbit=7, n=8),
    "N16384_k1_l3": lambda: params.test_params(N=16384, k=1, l=3, Bgbit=7, n=8),
    "N4096_k2_l6_bg4": lambda: params.test_params(N=4096, k=2, l=6, Bgbit=4, n=8),
    "N1024_k3_l9_bg3": lambda: params.test_params(N=1024, k=3, l=9, Bgbit=3, n=8),
    "N256_k5_l3": lambda: params.test_params(N=256, k=5, l=3, Bgbit=7, n=8),
    "N16_k1_l3": lambda: params.test_params(N=16, k=1, l=3, Bgbit=7, n=8),
    "N8_k1_l2": lambda: params.test_params(N=8, k=1, l=2, Bgbit=8, n=8),
    "N8192_k5_l1": lambda: params.test_params(N=8192, k=5, l=1, Bgbit=7, n=8),
    # refused by name before C10: K2 at 262,224 and 245,840 bytes, K3 at
    # 240,384 bytes (F = 512, Kp = 144), K1 and K3 at K = 288 (F = 64)
    "N4096_k3_l3": lambda: params.test_params(N=4096, k=3, l=3, Bgbit=7, n=8),
    "N4096_k4_l1": lambda: params.test_params(N=4096, k=4, l=1, Bgbit=7, n=8),
    "N4096_k1_l9_bg3": lambda: params.test_params(N=4096, k=1, l=9, Bgbit=3, n=8),
    "N512_k3_l9_bg3": lambda: params.test_params(N=512, k=3, l=9, Bgbit=3, n=8),
}
#: Repeats of each cluster shape: an ordering fault across the blocks of a
#: cluster shows only some of the time.
CLUSTER_REPEATS = 20


def _c10_plan(kernel, p):
    """The launcher's plan of ``kernel`` at ``p``; the cluster size is its last entry."""
    tg = p.tgsw_params
    U = tg.tlwe_params.k + 1
    if kernel == "K2":
        return blind_rotate_compact.kernel_plan(U, tg.tlwe_params.N, tg.kpl, tg.halfBg)
    if kernel == "K1":
        return blind_rotate.crt_mma_plan(U, ntt.kernel_context_for_params(p, device="cpu"), tg)
    return blind_rotate.crt_mma_plan(U, ntt.context_for_params(p, device="cpu"), tg,
                                     blind_rotate_v1.STAGE_BYTES)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [7, 13])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
@pytest.mark.parametrize("case", list(C10_CASES))
def test_kernels_match_plain_at_the_c10_shapes(case, kernel, B, cuda_device):
    """Each kernel takes the C10 shapes (all 8 steps; B = 13 leaves a ragged
    last block or cluster), bit for bit against its plain version, and a
    shape that runs in a cluster does so CLUSTER_REPEATS times in a row with
    the same words; where K1 has no context (N >= 4096) the refusal is by
    name, as in the reference."""
    _check_shape(C10_CASES[case](), kernel, B, cuda_device)


def _check_shape(p, kernel, B, device):
    """``kernel`` at ``p`` against its plain version, one launch; a cluster
    shape CLUSTER_REPEATS times more; K1's refusal by name at N >= 4096."""
    if kernel == "K1" and p.N >= 4096:
        with pytest.raises(ValueError, match=f"K1 .* has no context at N={p.N}"):
            ntt.kernel_context_for_params(p, device=device)
        return
    module, run, plain = _shape_rotation(kernel, p, device, B)
    before = module.launches
    out = run()
    torch.cuda.synchronize()
    assert module.launches == before + 1
    assert torch.equal(out, plain())
    if _c10_plan(kernel, p)[-1] > 1:
        for _ in range(CLUSTER_REPEATS):
            assert torch.equal(run(), out)


#: ROADMAP C11: shapes up to N = 16384 that the card refused after C10 (n =
#: 8): K2's limb sum bounded per pass, its staged tier, K3's and K1's stream
#: tier.
C11_CASES = {
    "N16384_k2_l3_bg8": lambda: params.test_params(N=16384, k=2, l=3, Bgbit=8, n=8),
    "N16384_k1_l4_bg8": lambda: params.test_params(N=16384, k=1, l=4, Bgbit=8, n=8),
    "N8192_k2_l8_bg4": lambda: params.test_params(N=8192, k=2, l=8, Bgbit=4, n=8),
    "N16384_k3_l2_bg7": lambda: params.test_params(N=16384, k=3, l=2, Bgbit=7, n=8),
    "N16384_k2_l4_bg4": lambda: params.test_params(N=16384, k=2, l=4, Bgbit=4, n=8),
    "N16384_k4_l4_bg8": lambda: params.test_params(N=16384, k=4, l=4, Bgbit=8, n=8),
    "N4096_k2_l15_bg2": lambda: params.test_params(N=4096, k=2, l=15, Bgbit=2, n=8),
    "N1024_k4_l32_bg1": lambda: params.test_params(N=1024, k=4, l=32, Bgbit=1, n=8),
    "N2048_k4_l32_bg1": lambda: params.test_params(N=2048, k=4, l=32, Bgbit=1, n=8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("B", [7, 13])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
@pytest.mark.parametrize("case", list(C11_CASES))
def test_kernels_match_plain_at_the_c11_shapes(case, kernel, B, cuda_device):
    """Each kernel takes the C11 shapes (all 8 steps; B = 13 a ragged last
    block), bit for bit against its plain version, and a shape that runs in
    a cluster does so CLUSTER_REPEATS times in a row with the same words;
    where K1 has no context (N >= 4096) the refusal is by name."""
    _check_shape(C11_CASES[case](), kernel, B, cuda_device)


#: ROADMAP C12: the rings past N = 16384 (n = 8) for K2: N = 32768 at k = 1
#: (its staged tier in a cluster of 8) and k = 2, 3, 4, N = 65536 at k = 1 and
#: 2 (its global tier), and the rows form's exact key at N = 32768 Bgbit = 3.
#: K1 and K3 have no context there, in both packages.
C12_CASES = {
    **{f"N{N}_k{k}_l3_bg8": (lambda N=N, k=k: params.test_params(N=N, k=k, l=3, Bgbit=8, n=8))
       for N, k in ((32768, 1), (32768, 2), (32768, 3), (32768, 4), (65536, 1), (65536, 2))},
    "N32768_k2_l3_bg3_rows": lambda: params.test_params(N=32768, k=2, l=3, Bgbit=3, n=8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("B", [7, 13])
@pytest.mark.parametrize("case", list(C12_CASES))
def test_k2_matches_plain_at_the_c12_shapes(case, B, cuda_device):
    """K2 takes the C12 shapes (all 8 steps; B = 13 a ragged last block of 8
    samples), bit for bit against its plain version (over the three-prime
    plan), and a shape in a cluster or in the global tier does so
    CLUSTER_REPEATS times in a row with the same words."""
    p = C12_CASES[case]()
    tg = p.tgsw_params
    U, N = tg.tlwe_params.k + 1, tg.tlwe_params.N
    if case.endswith("rows"):
        blind_rotate_compact.check_rows_domain(p)        # the rows form takes it
    in_memory = blind_rotate_compact.is_global(U, N, tg.kpl, tg.halfBg)
    assert in_memory == (case != "N32768_k1_l3_bg8")
    module, run, plain = _shape_rotation("K2", p, cuda_device, B)
    before = module.launches
    out = run()
    torch.cuda.synchronize()
    assert module.launches == before + 1
    assert torch.equal(out, plain())
    if in_memory or blind_rotate_compact.kernel_plan(U, N, tg.kpl, tg.halfBg)[3] > 1:
        for _ in range(CLUSTER_REPEATS):
            assert torch.equal(run(), out)


@pytest.mark.gpu
def test_c12_nand_at_n65536_runs_through_the_global_tier(cuda_device):
    """ROADMAP C12: a NAND at N = 65536 (k = 1 l = 4 Bgbit = 8, a shape the
    noise rail takes at n = 630; here 8 steps) over the compact key, keys
    made on the card, runs through K2's global tier in one launch and
    decrypts right."""
    p = params.test_params(N=65536, k=1, l=4, Bgbit=8, n=8)
    tg = p.tgsw_params
    assert blind_rotate_compact.is_global(2, 65536, tg.kpl, tg.halfBg)
    gen = torch.Generator(device=cuda_device).manual_seed(65)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p)
    ek = bootstrap.prepare_eval_key_fused(ks.cloud, p)
    a = torch.randint(0, 2, (13,), generator=gen, device=cuda_device).bool()
    b = torch.randint(0, 2, (13,), generator=gen, device=cuda_device).bool()
    ca, cb = (gates.encrypt_bit(gen, x, ks.lwe_key, p) for x in (a, b))
    before = blind_rotate_compact.launches
    out = gates.nand(ca, cb, ek, p)
    assert blind_rotate_compact.launches == before + 1
    assert torch.equal(gates.decrypt_bit(out, ks.lwe_key), ~(a & b))


@pytest.mark.gpu
def test_kernels_refuse_by_name_before_any_launch(cuda_device):
    """Shapes outside the domains after C11 raise by name, before any
    launch: K2 at halfBg > 128 (C1), the rows form where the reference's
    rows scan asserts, K1 where it has no context."""
    wide = params.test_params(N=1024, k=2, l=1, Bgbit=10, n=2)    # halfBg = 512
    rows, acc0, bara = _rotation_inputs(wide, 3, 50, cuda_device)
    before = blind_rotate_compact.launches
    with pytest.raises(ValueError, match="halfBg = 512 > 128"):
        blind_rotate_compact.blind_rotate_compact(acc0, bara, rows, wide)
    assert blind_rotate_compact.launches == before
    gen = torch.Generator(device=cuda_device).manual_seed(51)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, wide)
    with pytest.raises(ValueError, match="halfBg = 512 > 128"):
        bootstrap.prepare_eval_key_fused(ks.cloud, wide)
    big = params.test_params(N=16384, k=2, l=3, Bgbit=8, n=2)     # J*N*halfBg*128 >= 2^31
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, big)
    with pytest.raises(ValueError, match="rows eval-key form's int32 sum reaches 2,415,919,104"):
        bootstrap.prepare_eval_key(ks.cloud, big)
    assert bootstrap.prepare_eval_key_fused(ks.cloud, big).form == "compact"
    with pytest.raises(ValueError, match="K1 .* has no context at N=16384"):
        bootstrap.prepare_eval_key_ntt(ks.cloud, big)
    assert blind_rotate_compact.launches == before


@pytest.mark.gpu
def test_served_nand_on_the_card_matches_the_direct_call(cuda_device):
    """The gate server on the card (compute and download streams, pinned
    host buffers, several chunks) gives the direct call's words, for full
    and seeded uploads."""
    from eoc_tfhe_tpu_torch.serving import GateServer
    p = CASES["toy"]()
    gen = torch.Generator(device=cuda_device).manual_seed(60)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p)
    ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    B = 37
    a = torch.randint(0, 2, (B,), generator=gen, device=cuda_device).bool()
    b = torch.randint(0, 2, (B,), generator=gen, device=cuda_device).bool()
    ca, cb = (gates.encrypt_bit(gen, x, ks.lwe_key, p) for x in (a, b))
    sa, sb = (gates.encrypt_bit_seeded(gen, x, ks.lwe_key, p) for x in (a, b))
    before = blind_rotate.launches
    with GateServer(ek, p, max_batch=64, max_delay_s=0.01, pipeline_chunk=8) as srv:
        futs = [srv.submit("nand", lwe.lwe_index(ca, i), lwe.lwe_index(cb, i))
                for i in range(B)]
        futs += [srv.submit("nand", *(lwe.SeededLweCiphertext(c.seed[i], c.b[i],
                                                              c.current_variance[i])
                                      for c in (sa, sb)))
                 for i in range(B)]
        outs = lwe.lwe_stack([f.result(timeout=300) for f in futs])
    assert blind_rotate.launches > before
    assert outs.a.device.type == "cpu" and srv.stats["padded_slots"] == 0
    direct = gates.nand(ca, cb, ek, p)
    seeded = gates.nand(lwe.lwe_seeded_expand(sa, p.n), lwe.lwe_seeded_expand(sb, p.n), ek, p)
    for field in ("a", "b", "current_variance"):
        want = torch.cat([getattr(direct, field), getattr(seeded, field)]).cpu()
        assert torch.equal(getattr(outs, field), want), field
    assert torch.equal(gates.decrypt_bit(outs, lwe.LweKey(s=ks.lwe_key.s.cpu())),
                       torch.cat([~(a & b)] * 2).cpu())


@pytest.mark.gpu
def test_two_threads_first_use_of_build_load_builds_once(cuda_device, tmp_path, monkeypatch):
    """Two threads that load a kernel for the first time at once run nvcc
    once and get the same library."""
    name = "blind_rotate_compact"
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "SIGNATURES", {name: build.SIGNATURES[name]})
    builds = []
    real_build_all = build.build_all
    monkeypatch.setattr(build, "build_all", lambda: builds.append(1) or real_build_all())
    build._load.cache_clear()
    barrier = threading.Barrier(2)
    libs = []

    def first_use():
        barrier.wait()
        libs.append(build.load(name))
    threads = [threading.Thread(target=first_use) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        assert not any(t.is_alive() for t in threads)
    finally:
        build._load.cache_clear()      # later tests load from the package's build dir
    assert len(builds) == 1 and len(libs) == 2 and libs[0] is libs[1]
    assert [p.name for p in tmp_path.glob("*.so")] == [build._target(name).name]


# ---------------------------------------------------------------------------
# The llama tier and the native codec on the card's machine (no kernel of
# their own: the products are cuBLAS calls under device.exact_matmuls).
# ---------------------------------------------------------------------------

_DATA = Path(__file__).resolve().parent / "data"


@pytest.mark.gpu
def test_llama_golden_on_the_card_with_tf32_left_on(cuda_device):
    """The golden model on the card by default: float32 logits within 1e-5 of
    the float64 oracle's goldens even with the caller's TF32 flag on (the
    forward turns it off for its products), bf16 within 5e-3, greedy ids
    exactly; the caller's flags come back."""
    from eoc_tfhe_tpu_torch.models import checkpoint, llama

    gold = np.load(_DATA / "llama_tiny_golden.npz")
    cfg, np_params = checkpoint.load_llama2c(str(_DATA / "llama_tiny_v0.bin"))
    p = llama.params_from_numpy(np_params)
    assert p["wq"].device.type == "cuda"
    prompt = torch.from_numpy(gold["token_ids"][None].astype(np.int32)).to(cuda_device)
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    flags.allow_tf32 = flags.allow_bf16_reduced_precision_reduction = True
    try:
        logits32 = llama.forward(p, prompt, cfg, compute_dtype=torch.float32)
        logits_bf = llama.forward(p, prompt, cfg)
        gen = llama.generate(p, prompt, 8, cfg)
        assert flags.allow_tf32 and flags.allow_bf16_reduced_precision_reduction
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = old
    np.testing.assert_allclose(logits32.cpu().numpy(), gold["logits"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits_bf.cpu().numpy(), gold["logits"], atol=5e-3, rtol=0)
    np.testing.assert_array_equal(gen.cpu().numpy(), gold["generated"])


@pytest.mark.gpu
def test_llama_init_params_on_the_card_by_default(cuda_device):
    """init_params puts the weights on the card unless told otherwise and
    refuses a generator on the CPU; the forward then runs there."""
    from eoc_tfhe_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                            vocab_size=96, max_seq_len=32)
    p = llama.init_params(torch.Generator(device=cuda_device).manual_seed(0), cfg)
    assert all(v.device.type == "cuda" for v in p.values())
    with pytest.raises(ValueError, match="generator is on cpu"):
        llama.init_params(torch.Generator().manual_seed(0), cfg)
    logits = llama.forward(p, torch.zeros((1, 4), dtype=torch.int32, device=cuda_device), cfg)
    assert logits.shape == (1, 4, 96) and bool(torch.isfinite(logits).all())


@pytest.mark.gpu
def test_process_llama_serves_the_golden_on_the_card(cuda_device, tmp_path):
    """Process's Llama table on the card by default, over the virtual FS:
    the oracle's greedy continuation, and a prefill equal to the decode
    loop's continuation."""
    import json

    from eoc_tfhe_tpu_torch.io.virtualfs import LocalBackend, VirtualFS
    from eoc_tfhe_tpu_torch.models import tokenizer
    from eoc_tfhe_tpu_torch.process import Process

    (tmp_path / "m1").write_bytes((_DATA / "llama_tiny_v0.bin").read_bytes())
    (tmp_path / "m1.tokenizer").write_bytes((_DATA / "llama_tiny_tok.bin").read_bytes())
    gold = np.load(_DATA / "llama_tiny_golden.npz")
    tok = tokenizer.Tokenizer.load(str(_DATA / "llama_tiny_tok.bin"))
    text = "".join(tok.decode([int(t)]) for t in gold["generated"][0])
    proc = Process(params=params.test_params(), vfs=VirtualFS(LocalBackend(str(tmp_path))))
    env = json.dumps({"Process": {"Id": "AOS", "Owner": "FOOBAR", "Module": "M1"}})
    outs = []
    for src in ('Llama.load("m1")', 'Llama.setPrompt("hello world")', "return Llama.run(8)"):
        r = json.loads(proc.handle(json.dumps({
            "Tags": [{"name": "Action", "value": "Eval"}], "Data": src,
            "Block-Height": 100}), env))
        assert r["Error"] is None, r["Error"]
        outs.append(r["Output"]["data"]["output"])
    assert outs[-1] == text
    assert proc._llama_backend.model.params["wq"].device.type == "cuda"
    np.testing.assert_array_equal(proc._llama_backend.generated_ids("hello world", 8),
                                  gold["generated"][0])


@pytest.mark.gpu
def test_native_codec_builds_on_the_card_machine(cuda_device):
    from eoc_tfhe_tpu_torch import native
    from eoc_tfhe_tpu_torch.io import tfhe_io

    assert native.available(), "the native codec did not build (g++) or load"
    blob = (_DATA / "golden_lwesample_630.bin").read_bytes()
    assert tfhe_io.pack_lwe_samples(*native.unpack_lwe_array(blob, 1, 630)) == blob
    assert native.b64decode(base64.b64encode(blob).decode()) == blob


# ---------------------------------------------------------------------------
# The parallel tier on one card.
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_sharded_nand_on_one_nccl_rank_matches_gates_nand(cuda_device, tmp_path):
    """A one-rank NCCL group on the card: the dp NAND of
    FrameworkConfig(mesh_dp=1, mesh_tp=1).make_mesh() launches K2 and gives
    the words and variance of the direct ``gates.nand`` over the same key."""
    import torch.distributed as dist
    from eoc_tfhe_tpu_torch.config import FrameworkConfig
    from eoc_tfhe_tpu_torch.parallel import distributed, sharded
    p = COMPACT_CASES["toy"]()
    gen = torch.Generator(device=cuda_device).manual_seed(71)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p)
    ek = bootstrap.prepare_eval_key(ks.cloud, p)
    B = 19
    a = torch.randint(0, 2, (B,), generator=gen, device=cuda_device).bool()
    b = torch.randint(0, 2, (B,), generator=gen, device=cuda_device).bool()
    ca, cb = (gates.encrypt_bit(gen, x, ks.lwe_key, p) for x in (a, b))
    assert distributed.initialize(f"file://{tmp_path / 'store'}", 1, 0) is False
    try:
        assert dist.get_backend() == "nccl"
        m = FrameworkConfig(mesh_dp=1, mesh_tp=1).make_mesh()
        assert m.device == torch.device("cuda", 0)
        before = blind_rotate_compact.launches
        out = sharded.make_sharded_nand(m, p)(
            ca.a, ca.b, ca.current_variance, cb.a, cb.b, cb.current_variance,
            ek.bk_rows, ek.bk_variance, ek.ks_prepared, ks.cloud.bk.ks.variance)
        torch.cuda.synchronize()
        assert blind_rotate_compact.launches == before + 1
        ones = torch.ones(3, device=cuda_device)
        dist.all_reduce(ones)                       # the NCCL communicator runs
        assert ones.tolist() == [1.0, 1.0, 1.0]
    finally:
        dist.destroy_process_group()
    ref = gates.nand(ca, cb, ek, p)
    for got, want in zip(out, (ref.a, ref.b, ref.current_variance)):
        assert torch.equal(got, want)
    assert torch.equal(gates.decrypt_bit(ref, ks.lwe_key), ~(a & b))
