"""Device selection for the port's entry points, and the matmul precision
scope their products run in."""

from __future__ import annotations

import contextlib
import threading

import torch

#: torch's matmul precision flags are process-wide: this lock makes setting
#: them and the products they guard one step for every thread (the gate
#: server's worker, its callers, a llama decode).  Re-entrant, so a scope may
#: call code that opens its own.
_PRECISION_LOCK = threading.RLock()


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
