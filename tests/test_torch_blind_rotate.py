"""The port's NTT context, NTT-domain key and blind rotation against the JAX package.

On the CPU the blind rotation runs its plain version, held bit for bit
against the reference's XLA scan (``ntt.blind_rotate_ntt``) and its Pallas
kernel in interpret mode.  The rotation is exact for any TGSW rows, so the
full-width case uses random rows instead of a 128-bit keygen.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.ops import ntt as jntt
from eoc_tfhe_tpu.ops import pallas_ntt_blindrot2 as jpnb2

from eoc_tfhe_tpu_torch.ops import blind_rotate, ntt

CASES = {
    "toy": lambda: jparams.test_params(n=16, N=64, k=1, l=3, Bgbit=7),
    "bgbit10": lambda: jparams.test_params(n=8, N=64, k=1, l=2, Bgbit=10),
    "full_width_8_steps": lambda: jparams.default_128bit_params(),
}


def _inputs(p, n_steps, B, seed):
    tg = p.tgsw_params
    N, U = tg.tlwe_params.N, tg.tlwe_params.k + 1
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2**31, 2**31, (n_steps, tg.kpl, U, N), dtype=np.int64).astype(np.int32)
    acc0 = rng.integers(-2**31, 2**31, (B, U, N), dtype=np.int64).astype(np.int32)
    bara = rng.integers(0, 2 * N, (n_steps, B), dtype=np.int64).astype(np.int32)
    return rows, acc0, bara


def _jctx(p):
    return jpnb2.kernel_context_for_params(p)


@pytest.mark.parametrize("case", list(CASES))
def test_context_matches_reference(case):
    p = CASES[case]()
    ref = _jctx(p)
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    assert (ctx.N, ctx.R, ctx.F, ctx.primes, ctx.key_limbs, ctx.key_limb_bits, ctx.J) == (
        ref.N, ref.R, ref.F, ref.primes, ref.key_limbs, ref.key_limb_bits, ref.J)
    for mine, limbs in ((ctx.W, ref.Wf8), (ctx.Winv, ref.Wi8)):
        limbs = np.asarray(limbs).astype(np.int64)
        np.testing.assert_array_equal(mine.numpy(), limbs[:, 0] + 256 * limbs[:, 1])
    np.testing.assert_array_equal(ctx.omega.numpy(), np.asarray(ref.omega))


@pytest.mark.parametrize("case", list(CASES))
def test_prepared_key_matches_reference(case):
    p = CASES[case]()
    rows, _, _ = _inputs(p, 3, 1, seed=1)
    T8k = jntt.prepare_kernel_key_fast_np(rows, _jctx(p)).astype(np.int64)
    M = T8k.shape[-1] // 2
    key = ntt.prepare_kernel_key(torch.from_numpy(rows),
                                 ntt.kernel_context_for_params(p, device="cpu"))
    assert key.dtype == torch.int8 and key.numel() == 2 * T8k[..., :M].size
    np.testing.assert_array_equal(ntt.unpack_kernel_key(key).numpy(),
                                  T8k[..., :M] + 256 * T8k[..., M:])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_blind_rotation_matches_reference(case):
    p = CASES[case]()
    n_steps = min(p.n, 8)
    B = 3
    rows, acc0, bara = _inputs(p, n_steps, B, seed=2)
    jctx = _jctx(p)
    ref_kernel = np.asarray(jpnb2.blind_rotate_ntt_pallas2(
        jnp.asarray(acc0), jnp.asarray(bara), jnp.asarray(jntt.prepare_kernel_key_fast_np(rows, jctx)),
        jctx, p, block_b=B, interpret=True, expanded=False))
    sctx = jntt.context_for_params(p)
    ref_scan = np.asarray(jntt.blind_rotate_ntt(
        jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, sctx), p, sctx))
    np.testing.assert_array_equal(ref_kernel, ref_scan)

    ctx = ntt.kernel_context_for_params(p, device="cpu")
    key = ntt.prepare_kernel_key(torch.from_numpy(rows), ctx)
    out = blind_rotate.blind_rotate_ntt(torch.from_numpy(acc0), torch.from_numpy(bara),
                                        key, ctx, p)
    np.testing.assert_array_equal(out.numpy(), ref_kernel)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    p = CASES["toy"]()
    rows, acc0, bara = _inputs(p, 4, 2, seed=3)
    ctx = ntt.kernel_context_for_params(p, device="cpu")
    key = ntt.prepare_kernel_key(torch.from_numpy(rows), ctx)
    before = blind_rotate.launches
    out = blind_rotate.blind_rotate_ntt(torch.from_numpy(acc0), torch.from_numpy(bara),
                                        key, ctx, p)
    plain = blind_rotate.blind_rotate_ntt_plain(torch.from_numpy(acc0),
                                                torch.from_numpy(bara), key, ctx, p)
    assert blind_rotate.launches == before
    assert torch.equal(out, plain)
    with pytest.raises(ValueError, match="shape mismatch"):
        blind_rotate.blind_rotate_ntt(torch.from_numpy(acc0), torch.from_numpy(bara[:, :1]),
                                      key, ctx, p)
