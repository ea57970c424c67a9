"""The least time an H100 could take for a blind rotation, from the
parameter set, the configuration's plan constants and the batch alone.

The count is the CRT-NTT dataflow, the fewest-operation exact dataflow the
repository has (int8 limb MACs: a forward transform of the digits, the
pointwise product, the inverse), at constants the configuration file
states (``roofline``: P primes, R, F, L key limbs, dl digit limbs), so a
change of the key's layout, the plan or the kernel leaves the bound as it
is.  Bytes: the bootstrapping key as int32 TGSW rows, the accumulators in
and out and bara, each moved once.  Peaks: NVIDIA's H100 SXM data sheet,
dense int8 1,979 TOP/s and HBM3 3.35 TB/s, at the 700 W limit.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def ntt_macs(P: int, F: int, K: int, M: int, dl: int) -> int:
    """int8 limb MACs per sample and step: forward K*F*F with 2 matrix
    limbs and dl digit limbs, pointwise F*K*M with 2x2 limbs, inverse
    M*F*F with 2x2 limbs, for each of P primes."""
    return P * (K * F * F * 2 * dl + F * K * M * 4 + M * F * F * 4)


def bound_ms(macs: int, nbytes: int) -> tuple[float, str]:
    """The larger of the operation time (2 ops a MAC at the int8 peak) and
    the byte time (at the HBM rate), and which one it is."""
    t_ops = 2 * macs / INT8_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rotation_bound_ms(config: dict, B: int) -> tuple[float, str]:
    """The bound of one blind rotation over B samples at ``config``'s set."""
    p, r = config["params"], config["roofline"]
    n, N, k, l = p["n"], p["N"], p["k"], p["bk_l"]
    K, M = (k + 1) * l * r["R"], r["L"] * (k + 1) * r["R"]
    dl = 1 if (1 << (p["bk_Bgbit"] - 1)) <= 128 else 2
    key_bytes = n * (k + 1) * l * (k + 1) * N * 4
    nbytes = key_bytes + 2 * B * (k + 1) * N * 4 + n * B * 4
    return bound_ms(ntt_macs(r["P"], r["F"], K, M, dl) * B * n, nbytes)
