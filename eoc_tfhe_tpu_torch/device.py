"""Device selection for the port's entry points, the matmul precision
scope their products run in, and the gate path's constants built once on a
device."""

from __future__ import annotations

import contextlib
import threading

import torch

#: torch's matmul precision flags are process-wide: this lock makes setting
#: them and the products they guard one step for every thread (the gate
#: server's worker, its callers, a llama decode).  Re-entrant, so a scope may
#: call code that opens its own.
_PRECISION_LOCK = threading.RLock()

#: Gate-path constants built on a device (:func:`device_constant`) in this
#: process, a count like ``ops.blind_rotate.launches``: it grows in a key's
#: first calls and never again.
gate_constants = 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names one.

    Raises when the card is asked for (explicitly or by default) and none is
    present: the port never moves to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


@contextlib.contextmanager
def exact_matmuls():
    """Products inside the block run as XLA runs them: float32 products in
    full float32 (TF32 off) and bf16 products reduced in float32 (cuBLAS's
    reduced-precision bf16 reduction off).  The caller's settings come back
    on exit; other threads wait for the block."""
    flags = torch.backends.cuda.matmul
    with _PRECISION_LOCK:
        prev = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
        flags.allow_tf32 = False
        flags.allow_bf16_reduced_precision_reduction = False
        try:
            yield
        finally:
            flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = prev


def device_constant(cache: dict, key, build) -> torch.Tensor:
    """``cache[key]``, built by ``build()`` on its first use.

    The gate path keeps its scalars and small index tensors (the output
    variance of a key's blind rotation, the keyswitch's digit shifts and
    rounding variance) on the device this way: a tensor made from Python
    numbers on each call is a pageable copy that makes the host wait for the
    stream, while a memoised one lets the host queue the next gate during
    the current rotation.  ``key`` names the device, and everything the
    tensor is computed from that is not fixed by ``cache``'s owner."""
    global gate_constants
    x = cache.get(key)
    if x is None:
        x = cache[key] = build()
        gate_constants += 1
    return x
