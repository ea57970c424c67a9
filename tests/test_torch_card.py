"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (the kernels have no CPU or interpret mode) and
skip without one. They import only the port, so they also run where JAX is
absent:  python -m pytest --noconftest tests/test_torch_card.py -q
"""

import pytest
import torch

from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, params
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
