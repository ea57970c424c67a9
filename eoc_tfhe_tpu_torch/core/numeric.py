"""Torus numerics: exact Torus32 arithmetic as int32 with wraparound.

Port of ``eoc_tfhe_tpu/core/numeric.py``.  Torch has no unsigned 32-bit
shift on the CPU, so logical shifts and every product that may leave the
int32 range run in int64 and are folded back with :func:`wrap32`.
Randomness comes from an explicit ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

_TWO32 = 1 << 32
_TWO63 = 1 << 63
_MASK32 = 0xFFFFFFFF


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's-complement wrap)."""
    return (((x + (1 << 31)) & _MASK32) - (1 << 31)).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> its unsigned value in [0, 2^32), held as int64."""
    return x.to(torch.int64) & _MASK32


# ---------------------------------------------------------------------------
# Host (numpy) exact semantics, any Msize.
# ---------------------------------------------------------------------------

def _interv(Msize: int) -> int:
    return (_TWO63 // int(Msize)) * 2


def mod_switch_to_torus32_np(mu, Msize: int) -> np.ndarray:
    """Exact ``modSwitchToTorus32``: message in Z_Msize -> Torus32 phase."""
    interv = np.uint64(_interv(Msize))
    mu_u = np.asarray(mu, dtype=np.int64).astype(np.uint64)
    with np.errstate(over="ignore"):
        phase64 = mu_u * interv
    return (phase64 >> np.uint64(32)).astype(np.uint32).astype(np.int32)


def mod_switch_from_torus32_np(phase, Msize: int) -> np.ndarray:
    """Exact ``modSwitchFromTorus32``: Torus32 phase -> nearest message in Z_Msize."""
    interv = np.uint64(_interv(Msize))
    half = interv // np.uint64(2)
    phase_u = np.asarray(phase, dtype=np.int32).astype(np.uint32).astype(np.uint64)
    with np.errstate(over="ignore"):
        phase64 = (phase_u << np.uint64(32)) + half
    return (phase64 // interv).astype(np.int64)


def approx_phase_np(phase, Msize: int) -> np.ndarray:
    """Exact ``approxPhase``: round a torus phase to the nearest of Msize slots."""
    interv = np.uint64(_interv(Msize))
    half = interv // np.uint64(2)
    phase_u = np.asarray(phase, dtype=np.int32).astype(np.uint32).astype(np.uint64)
    with np.errstate(over="ignore"):
        phase64 = (phase_u << np.uint64(32)) + half
        phase64 -= phase64 % interv
    return (phase64 >> np.uint64(32)).astype(np.uint32).astype(np.int32)


def double_to_t32(d: float) -> int:
    """Host-side exact dtot32 for a Python float (used for gate constants)."""
    frac = d - int(d)
    v = int(frac * _TWO32)
    v &= _MASK32
    return v - _TWO32 if v >= 2**31 else v


def t32_to_double(t) -> np.ndarray:
    """Torus32 -> centered double in [-1/2, 1/2) (upstream ``t32tod``).

    Host-side numpy; exact (int32 / 2^32 is representable in float64).
    """
    return np.asarray(t, np.int32).astype(np.float64) / _TWO32


# ---------------------------------------------------------------------------
# Tensor paths.
# ---------------------------------------------------------------------------

def _log2_exact(Msize: int) -> int:
    m = int(Msize).bit_length() - 1
    if (1 << m) != Msize:
        raise ValueError("mod switches on tensors require a power-of-two Msize; "
                         "use mod_switch_to_torus32_np for the general case")
    return m


def mod_switch_to_torus32(mu: torch.Tensor, Msize: int) -> torch.Tensor:
    """``modSwitchToTorus32`` for power-of-two Msize: mu * 2^(32-m) mod 2^32."""
    m = _log2_exact(Msize)
    return wrap32(mu.to(torch.int64) << (32 - m))


def mod_switch_from_torus32(phase: torch.Tensor, Msize: int) -> torch.Tensor:
    """``modSwitchFromTorus32`` for power-of-two Msize:
    (uint32(phase) + 2^(31-m)) >> (32-m), a logical shift done in int64."""
    m = _log2_exact(Msize)
    u = (as_u32(phase) + (1 << (31 - m))) & _MASK32
    return (u >> (32 - m)).to(torch.int32)


def dtot32(d: torch.Tensor) -> torch.Tensor:
    """double -> Torus32 in float32, the same operations as the reference."""
    frac = d - torch.trunc(d)
    scaled = torch.trunc(frac * np.float32(_TWO32))
    zero = torch.zeros((), dtype=scaled.dtype, device=scaled.device)
    wrapped = scaled - torch.where(scaled >= np.float32(2**31),
                                   zero + np.float32(_TWO32), zero)
    wrapped = wrapped + torch.where(wrapped < np.float32(-(2**31)),
                                    zero + np.float32(_TWO32), zero)
    return wrapped.to(torch.int32)


def gaussian32(mu: torch.Tensor, sigma: float, generator: torch.Generator,
               shape) -> torch.Tensor:
    """``gaussian32``: torus gaussian sample around ``mu`` with stddev ``sigma``."""
    noise = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                        device=generator.device) * np.float32(sigma)
    return wrap32(mu.to(torch.int64) + dtot32(noise).to(torch.int64))


def uniform_torus32(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform Torus32 sample (upstream ``uniformTorus32_distrib``)."""
    return torch.randint(-(1 << 31), 1 << 31, tuple(shape), generator=generator,
                         dtype=torch.int64, device=generator.device).to(torch.int32)


def uniform_binary(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform {0,1} int32 sample (LWE/TLWE key coefficients)."""
    return torch.randint(0, 2, tuple(shape), generator=generator,
                         dtype=torch.int32, device=generator.device)
