"""The blind rotation over the NTT-domain key: CUDA kernel and plain version.

Replaces the TPU kernel ``eoc_tfhe_tpu/ops/pallas_ntt_blindrot2.py``
(``blind_rotate_ntt_pallas2``, its ``pallas_call`` at line 648).  Its
contract is the reference's output bits: each CMux step adds the exact
negacyclic product  sum_j digits_j (*) bk[i, j, u]  mod 2^32, so any exact
dataflow gives the same bits.

:func:`blind_rotate_ntt` is the wrapper.  For a tensor on the CPU it runs
:func:`blind_rotate_ntt_plain`; for a CUDA tensor it launches the
hand-written kernel in ``csrc/blind_rotate_ntt.cu`` or raises.  ``launches``
counts kernel launches and nothing else.  :func:`launch_kernel` also launches
the "ntt_scan" form's kernel (``ops/blind_rotate_v1.py``), which shares the
dataflow and its arguments.
"""

from __future__ import annotations

import torch

from ..core.numeric import wrap32
from ..core.tgsw import decompose_h
from . import rotate
from .ntt import NttContext, balanced_mod

#: Number of launches of the CUDA kernel in this process.
launches = 0


def check_shapes(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                 ctx: NttContext, params, key_cols: int = 1):
    """Check a rotation's shapes against the plan; returns (B, U, N, n).
    ``key_cols`` is 1 for an int16 key (n, P, F, K, M) and 2 for a byte-pair
    key (n, P, F, K, 2M)."""
    B, U, N = acc0.shape
    n, P, F, K, MC = key.shape
    M = MC // key_cols
    tg = params.tgsw_params
    ok = (N == ctx.N and F == ctx.F and P == len(ctx.primes) == 2 and MC == M * key_cols
          and K == tg.kpl * ctx.R and tg.kpl == U * tg.l and U == tg.tlwe_params.k + 1
          and M == ctx.key_limbs * U * ctx.R and tuple(bara.shape) == (n, B))
    if not ok:
        raise ValueError(f"shape mismatch: acc0 {tuple(acc0.shape)}, bara "
                         f"{tuple(bara.shape)}, key {tuple(key.shape)}")
    return B, U, N, n


def external_product_plain(digits: torch.Tensor, key_step: torch.Tensor,
                           ctx: NttContext) -> torch.Tensor:
    """Exact  sum_j digits[b, j] (negacyclic*) bk_step[j, u]  mod 2^32.

    The ``ops/ntt.py`` algorithm of the reference in torch.  Each modular
    product is a float64 matmul of exact integers below 2^53 (|digit| <=
    halfBg, |residue| < 2^15, so forward < 2^31, pointwise K*2^30 and inverse
    F*2^30), followed by an integer reduction.

    Args:
      digits: (B, J, N) int32 gadget digits.
      key_step: (P, F, K, M) int16, one step of the prepared key.
    Returns (B, U, N) int32.
    """
    B, J, N = digits.shape
    R, F, L = ctx.R, ctx.F, ctx.key_limbs
    P, _, K, M = key_step.shape
    U = M // (L * R)
    sub = digits.reshape(B, J, F, R).transpose(-1, -2).to(torch.float64)   # (B,J,R,F)
    res = []
    for pi, p in enumerate(ctx.primes):
        dhat = balanced_mod(sub @ ctx.W[pi].to(torch.float64), p)          # (B,J,R,F)
        dhat = dhat.reshape(B, K, F).permute(2, 0, 1).to(torch.float64)    # (F,B,K)
        chat = balanced_mod(torch.bmm(dhat, key_step[pi].to(torch.float64)), p)
        chat = chat.permute(1, 2, 0).to(torch.float64)                     # (B,M,F)
        res.append(balanced_mod(chat @ ctx.Winv[pi].to(torch.float64), p))
    p1, p2 = ctx.primes
    t = balanced_mod((res[1] - res[0]) * ctx.crt_inv, p2)
    V = (res[0] + t * p1).reshape(B, L, U, R, F)      # exact integer, |V| < p1*p2/2
    out = torch.zeros((B, U, R, F), dtype=torch.int64, device=digits.device)
    for li in range(L):
        out = out + (V[:, li] << (ctx.key_limb_bits * li))
    return wrap32(out).transpose(-1, -2).reshape(B, U, N)    # index m = t*R + s


def cmux_ntt_step(acc: torch.Tensor, key_step: torch.Tensor, bara_i: torch.Tensor,
                  ctx: NttContext, params) -> torch.Tensor:
    """One CMux step over the NTT-domain key: acc + bk_i (.) ((X^a - 1) acc).

    Args:
      acc: (B, k+1, N) int32; key_step: (P, F, K, M) int16; bara_i: (B,) int32.
    """
    rot = rotate.mul_by_xai(acc, bara_i[:, None])
    d = wrap32(rot.to(torch.int64) - acc.to(torch.int64))
    delta = external_product_plain(decompose_h(d, params.tgsw_params), key_step, ctx)
    return wrap32(acc.to(torch.int64) + delta.to(torch.int64))


def blind_rotate_ntt_plain(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                           ctx: NttContext, params) -> torch.Tensor:
    """Plain PyTorch blind rotation (``ops/ntt.blind_rotate_ntt`` of the reference).

    Args:
      acc0: (B, k+1, N) int32; bara: (n, B) int32 in [0, 2N);
      key: (n, P, F, K, M) int16 from ``ntt.prepare_kernel_key``.
    Returns (B, k+1, N) int32.
    """
    n = check_shapes(acc0, bara, key, ctx, params)[3]
    acc = acc0
    for i in range(n):
        acc = cmux_ntt_step(acc, key[i], bara[i], ctx, params)
    return acc


def launch_kernel(name: str, acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                  ctx: NttContext, params, key_dtype: torch.dtype) -> torch.Tensor:
    """Launch the CRT-NTT kernel of ``csrc/<name>.cu`` on CUDA tensors and
    return its output; raises on a bad operand or a refused launch.  The
    caller counts the launch.  ``key_dtype`` is int16 for a key of residues
    (n, P, F, K, M) and int8 for one of byte pairs (n, P, F, K, 2M).
    """
    from ..kernels import build

    B, U, N, n = check_shapes(acc0, bara, key, ctx, params,
                              key_cols=1 if key_dtype == torch.int16 else 2)
    for arg, x, dt in (("acc0", acc0, torch.int32), ("bara", bara, torch.int32),
                       ("key", key, key_dtype), ("W", ctx.W, torch.int16),
                       ("Winv", ctx.Winv, torch.int16)):
        if (x.device != acc0.device or x.dtype != dt or not x.is_contiguous()
                or x.data_ptr() % 8):
            raise ValueError(f"{arg} must be a contiguous, 8-byte aligned {dt} "
                             f"tensor on {acc0.device}, got {x.dtype} on {x.device}")
    out = torch.empty_like(acc0)
    tg = params.tgsw_params
    lib = build.load(name)
    stream = torch.cuda.current_stream(acc0.device).cuda_stream
    with torch.cuda.device(acc0.device):
        err = getattr(lib, build.SIGNATURES[name][0])(
            acc0.data_ptr(), bara.data_ptr(), key.data_ptr(), ctx.W.data_ptr(),
            ctx.Winv.data_ptr(), out.data_ptr(), B, n, U, N, ctx.R, tg.l, tg.Bgbit,
            ctx.key_limbs, ctx.key_limb_bits, ctx.primes[0], ctx.primes[1],
            ctx.crt_inv, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.kernel_error_string(err).decode()})")
    return out


def blind_rotate_ntt(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                     ctx: NttContext, params) -> torch.Tensor:
    """All n CMux steps of the blind rotation.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (no fallback)."""
    global launches
    if acc0.device.type == "cpu":
        return blind_rotate_ntt_plain(acc0, bara, key, ctx, params)
    if acc0.device.type != "cuda":
        raise ValueError(f"unsupported device {acc0.device}")
    out = launch_kernel("blind_rotate_ntt", acc0, bara, key, ctx, params, torch.int16)
    launches += 1
    return out
