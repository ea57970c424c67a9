"""The blind rotation of the "ntt_scan" form: CUDA kernel and plain version.

Replaces the TPU kernel ``eoc_tfhe_tpu/ops/pallas_ntt_blindrot.py``
(``blind_rotate_ntt_pallas``, line 146, its ``pallas_call`` at line 321),
which computes the reference's ``ops/ntt.blind_rotate_ntt`` scan over the
unpadded v1 key ``(n, P, F, K, 2M)`` int8, [lo | hi] bytes of the balanced
residues, for either prime pair.  Its contract is the scan form's bits: each
CMux step adds the exact negacyclic product mod 2^32.  The TPU kernel casts
the gadget digits to int8 and is wrong for halfBg > 128 (ROADMAP C3); the port
gives the scan form's bits at every parameter set.

:func:`blind_rotate_ntt_v1` is the wrapper.  For a tensor on the CPU it runs
:func:`blind_rotate_ntt_v1_plain`; for a CUDA tensor it launches the
hand-written int8 tensor-core kernel in ``csrc/blind_rotate_ntt_v1.cu`` (the
dataflow of ``csrc/crt_ntt_mma.cuh``, shared with K1, over this form's own
key, transposed on the chip) or raises: :func:`check_kernel_domain` refuses,
by name and before any launch, a shape the kernel does not take.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from .blind_rotate import (check_crt_mma_domain, check_operands, cmux_ntt_step,
                           crt_mma_plan, kernel_scratch_bytes, launch_error)
from .ntt import NttContext, join_key_bytes

#: Number of launches of the CUDA kernel in this process.
launches = 0

#: Shared memory per warp of the kernel's key loader (``V1Key::kStageBytes``):
#: a 16 x 16 tile per byte plane, each padded by 16 bytes.
STAGE_BYTES = 2 * (16 * 16 + 16)


def check_kernel_domain(U: int, ctx: NttContext, tg) -> None:
    """K3's domain (``csrc/blind_rotate_ntt_v1.cu``): raise ``ValueError``, by
    name, for a shape its launcher refuses.  Its pointwise sum reduces C2
    first, so either prime pair is in range."""
    check_crt_mma_domain("K3 (blind_rotate_ntt_v1)", U, ctx, tg, reduce_c2=True,
                         stage_bytes=STAGE_BYTES)


def check_shapes(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                 ctx: NttContext, params):
    """Check a rotation's shapes against the plan for the byte-pair key
    (n, P, F, K, 2M); returns (B, U, N, n)."""
    B, U, N = acc0.shape
    n, P, F, K, M2 = key.shape
    tg = params.tgsw_params
    ok = (N == ctx.N and F == ctx.F and P == len(ctx.primes) == 2
          and K == tg.kpl * ctx.R and tg.kpl == U * tg.l and U == tg.tlwe_params.k + 1
          and M2 == 2 * ctx.key_limbs * U * ctx.R and tuple(bara.shape) == (n, B))
    if not ok:
        raise ValueError(f"shape mismatch: acc0 {tuple(acc0.shape)}, bara "
                         f"{tuple(bara.shape)}, key {tuple(key.shape)}")
    return B, U, N, n


def blind_rotate_ntt_v1_plain(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                              ctx: NttContext, params) -> torch.Tensor:
    """Plain PyTorch blind rotation over the byte-pair key (the reference's
    ``ntt.blind_rotate_ntt`` / ``external_product_ntt``): each step's int16
    residues are rebuilt from their two bytes.

    Args:
      acc0: (B, k+1, N) int32; bara: (n, B) int32 in [0, 2N);
      key: (n, P, F, K, 2M) int8 from ``ntt.prepare_key_ntt``.
    Returns (B, k+1, N) int32.
    """
    n = check_shapes(acc0, bara, key, ctx, params)[3]
    acc = acc0
    for i in range(n):
        acc = cmux_ntt_step(acc, join_key_bytes(key[i]), bara[i], ctx, params)
    return acc


def blind_rotate_ntt_v1(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                        ctx: NttContext, params) -> torch.Tensor:
    """All n CMux steps over the "ntt_scan" key.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (no fallback)."""
    global launches
    if acc0.device.type == "cpu":
        return blind_rotate_ntt_v1_plain(acc0, bara, key, ctx, params)
    if acc0.device.type != "cuda":
        raise ValueError(f"unsupported device {acc0.device}")
    out = _launch(acc0, bara, key, ctx, params)
    launches += 1
    return out


def _launch(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
            ctx: NttContext, params) -> torch.Tensor:
    """Launch ``csrc/blind_rotate_ntt_v1.cu`` on CUDA tensors and return its
    output; raises on a bad operand or a refused launch."""
    from ..kernels import build

    B, U, N, n = check_shapes(acc0, bara, key, ctx, params)
    tg = params.tgsw_params
    check_kernel_domain(U, ctx, tg)
    check_operands(acc0, (("acc0", acc0, torch.int32), ("bara", bara, torch.int32),
                          ("key", key, torch.int8), ("W_mma", ctx.W_mma, torch.int8),
                          ("Winv_mma", ctx.Winv_mma, torch.int8)))
    out = torch.empty_like(acc0)
    samples, _, cluster = crt_mma_plan(U, ctx, tg, STAGE_BYTES)
    scratch = torch.empty(kernel_scratch_bytes(B, U, ctx, tg, samples, cluster),
                          dtype=torch.uint8, device=acc0.device)
    lib = build.load("blind_rotate_ntt_v1")
    stream = torch.cuda.current_stream(acc0.device).cuda_stream
    with torch.cuda.device(acc0.device):
        err = lib.blind_rotate_ntt_v1_launch(
            acc0.data_ptr(), bara.data_ptr(), key.data_ptr(), ctx.W_mma.data_ptr(),
            ctx.Winv_mma.data_ptr(), scratch.data_ptr(), scratch.numel(), out.data_ptr(),
            B, n, U, N, ctx.R, tg.l, tg.Bgbit, ctx.key_limbs, ctx.key_limb_bits,
            ctx.key_round_bits, ctx.primes[0], ctx.primes[1], ctx.crt_inv, stream)
    if err != 0:
        raise launch_error("blind_rotate_ntt_v1", lib, err)
    return out
