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
hand-written kernel in ``csrc/blind_rotate_ntt_v1.cu`` or raises.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from .blind_rotate import check_shapes, cmux_ntt_step, launch_kernel
from .ntt import NttContext, join_key_bytes

#: Number of launches of the CUDA kernel in this process.
launches = 0


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
    n = check_shapes(acc0, bara, key, ctx, params, key_cols=2)[3]
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
    out = launch_kernel("blind_rotate_ntt_v1", acc0, bara, key, ctx, params, torch.int8)
    launches += 1
    return out
