"""The blind rotation over the stored ("compact") key: CUDA kernel and plain version.

Replaces the TPU kernel ``eoc_tfhe_tpu/ops/pallas_blindrot.py``
(``blind_rotate_pallas``, its ``pallas_call`` at line 208).  Its contract is
bits: each CMux step adds the exact negacyclic product
sum_j digits_j (*) key[i, j, u] mod 2^32 against the *stored* key, which is
the true key or, for ``limbs < 4``, the key rounded to a multiple of
2^(8*(4-limbs)).  The port stores the key as int32 rows; the kernel splits
each step into balanced byte limbs and multiplies Toeplitz blocks of them by
the int8 digits on the tensor cores, as the TPU kernel does on its matrix
unit, which gives the same bits.

:func:`blind_rotate_compact` is the wrapper.  For a tensor on the CPU it
runs :func:`blind_rotate_compact_plain` (the rows scan); for a CUDA tensor it
launches the hand-written kernel in ``csrc/blind_rotate_compact.cu`` or
raises: :func:`check_kernel_domain` refuses, by name and before any launch,
a shape the kernel does not take (it takes every k and every power-of-two N
from 8 with l*Bgbit <= 32 and halfBg <= 128: the digit rows a share at a
time where one sample's digits do not fit a cluster of 8 blocks, each pass's
int32 limb sum below 2^31, as the reference's fused kernel bounds it per
chunk, and, where no plan holds a sample's share of the accumulators in
shared memory (N >= 32768), the global tier: the accumulators and the
step's digits in device memory, the limb sums bounded per contraction chunk
of ``GLOBAL_CHUNK`` coefficients; what the card's memory cannot hold is
refused at the launch, by name, with its bytes).  ``launches`` counts
rotations launched (the global tier's kernels launch a step at a time) and
nothing else.
"""

from __future__ import annotations

import torch

from ..core.numeric import wrap32
from ..core.params import GateBootstrappingParams
from ..core.tgsw import decompose_h
from . import ntt, polymul, rotate
from .blind_rotate import SMEM_PER_BLOCK

#: Number of launches of the CUDA kernel in this process.
launches = 0


def check_digit_domain(params: GateBootstrappingParams) -> None:
    """Raise where the reference's "rows" and "fused" forms are wrong.

    Both cast the gadget digits to int8 (``ops/polymul.py:134``,
    ``ops/pallas_blindrot.py:164``), which wraps for halfBg > 128 (the 80-bit
    set has halfBg = 512) and silently gives wrong bits.  The port refuses
    those parameter sets for these forms instead of copying the fault.
    """
    half = params.tgsw_params.halfBg
    if half > 128:
        raise ValueError(
            f"halfBg = {half} > 128: the compact and rows eval-key forms are exact "
            "only for int8 gadget digits; use the ntt_kernel form")


def smem_bytes(U: int, N: int, J: int, samples: int, limbs: int, rows: int | None = None,
               cluster: int = 1, general: bool = False, staged: bool = False,
               global_tier: bool = False) -> int:
    """Shared memory of a K2 block: the accumulators (samples, U*N + 4)
    uint32, the digits (samples, J*N + 16) int8 and the byte rows (limbs,
    rows, U, 2N) int8 of the key limbs and digit rows converted a pass (all
    J rows unless ``rows`` is given), + 16.  The general kernel
    (``general``) holds a block's share of the accumulators (samples, U*N/C
    + 4) in a cluster of C = ``cluster`` blocks, digit rows of max(N, 32)
    bytes, and of each key row the window its outputs meet plus 32 bytes
    (2N + 32, or N + N/C + 32 in a cluster).  Its staged tier (``staged``)
    holds only the ``rows`` digit rows of the current share and, beside the
    accumulators' share, an update buffer of the same size.  The global tier
    (``global_tier``) holds a block's sums (samples, ``GLOBAL_TILE`` + 4)
    uint32, the pass's digit chunks (samples, rows*``GLOBAL_CHUNK`` + 16) and
    each row's key window (``GLOBAL_TILE`` + ``GLOBAL_CHUNK`` + 32 bytes a
    limb), whatever U, N and J."""
    rows = J if rows is None else rows
    if global_tier:
        return (samples * (GLOBAL_TILE + 4) * 4 + samples * (rows * GLOBAL_CHUNK + 16)
                + limbs * rows * (GLOBAL_TILE + GLOBAL_CHUNK + 32) + 16)
    if not general:
        return samples * (U * N + 4) * 4 + samples * (J * N + 16) + limbs * rows * U * 2 * N + 16
    Ns = N // cluster
    RW = (2 * N if cluster == 1 else N + Ns) + 32
    held = rows if staged else J
    return ((2 if staged else 1) * samples * (U * Ns + 4) * 4 + samples * (held * max(N, 32) + 16)
            + limbs * rows * U * RW + 16)


#: K2's (samples a block, key limbs converted a pass) with all J digit rows a
#: pass, in the launcher's order of preference for the instantiations (U = 2
#: to 5, N from 32 to 4096): the first whose block fits is taken; then
#: (samples, 1 limb, the most rows below J that fit) for samples 8, 4, 2.
PLANS = ((8, 4), (8, 1), (4, 4), (4, 1), (2, 4), (2, 1))
#: Blocks a cluster of the general kernel (the portable limit is 8).
CLUSTERS = (1, 2, 4, 8)
#: The global tier (``blind_rotate_compact_global``): output coefficients of
#: one polynomial a block (its 8 warps' walks of 32 tiles), input coefficients
#: a pass (the contraction chunk whose int32 sums are bounded), samples a
#: block (the MMA's 8 columns), and the most digit rows a pass, each with its
#: four key limbs' windows (217,744 bytes; a fourth row needs 246,544).
GLOBAL_TILE, GLOBAL_CHUNK, GLOBAL_SAMPLES, GLOBAL_ROWS = 4096, 1024, 8, 3


def max_cluster(N: int) -> int:
    """The largest cluster the general kernel takes at N: each block's share
    of a polynomial holds at least one walk of 16 or 32 output tiles."""
    if N < 1024:
        return 1
    return min(8, N // (16 * (32 if N >= 2048 else 16)))


def max_rows(N: int, halfBg: int) -> int:
    """The most digit rows a pass whose limb sums stay in int32: one MMA
    accumulator collects rows * N products |digit| * |byte| <= halfBg * 128
    between two additions into acc (the reference's fused kernel bounds the
    same sum per chunk of 128 coefficients, ``pallas_blindrot.py:135``)."""
    return ((1 << 31) - 1) // (N * halfBg * 128)


def chunk_rows(halfBg: int) -> int:
    """The most digit rows a pass of the global tier whose limb sums stay in
    int32: one MMA accumulator collects rows * ``GLOBAL_CHUNK`` products
    |digit| * |byte| <= halfBg * 128 before the block adds it into its sums
    mod 2^32 -- the reference's per-chunk rule (J C halfBg 128 < 2^31,
    ``pallas_blindrot.py:135``) with the chunk ``GLOBAL_CHUNK``; N does not
    enter it."""
    return ((1 << 31) - 1) // (GLOBAL_CHUNK * halfBg * 128)


def is_general(U: int, N: int, plan: tuple[int, int, int, int], staged: bool = False) -> bool:
    """Whether ``plan`` runs the general kernel: a shape past the
    instantiations (U = 2 to 5, N from 32 to 4096), one sample a block, a
    cluster, or the staged tier (``staged``, :func:`is_staged`)."""
    return (staged or not 2 <= U <= 5 or not 32 <= N <= 4096 or plan[0] == 1
            or plan[3] > 1)


def _plans(U: int, N: int, J: int, halfBg: int):
    """The launcher's plans in its order of preference, each (samples, limbs
    a pass, digit rows a pass, blocks a cluster, general, staged, global)."""
    top = max_rows(N, halfBg)
    if 2 <= U <= 5 and 32 <= N <= 4096:
        for samples, limbs in PLANS:
            yield samples, limbs, J, 1, False, False, False
        for samples in (8, 4, 2):
            for rows in range(J - 1, 0, -1):
                yield samples, 1, rows, 1, False, False, False
    clusters = [C for C in CLUSTERS if C <= max_cluster(N)]
    for staged in (False, True):
        for C in clusters:
            for samples in (8, 4, 2, 1):
                if staged:
                    shares = [(limbs, r) for limbs in (4, 1) for r in range(min(J, top), 0, -1)]
                else:
                    shares = [(4, J), (1, J), *((1, r) for r in range(J - 1, 0, -1))]
                for limbs, rows in shares:
                    yield samples, limbs, rows, C, True, staged, False
    if N >= GLOBAL_TILE:
        yield GLOBAL_SAMPLES, 4, min(J, GLOBAL_ROWS), 1, True, False, True


def _fits(U: int, N: int, J: int, halfBg: int, plan) -> bool:
    samples, limbs, rows, C, general, staged, global_tier = plan
    return (rows <= (chunk_rows(halfBg) if global_tier else max_rows(N, halfBg))
            and smem_bytes(U, N, J, samples, limbs, rows, C, general, staged,
                           global_tier) <= SMEM_PER_BLOCK)


def _plan(U: int, N: int, J: int, halfBg: int):
    for plan in _plans(U, N, J, halfBg):
        if _fits(U, N, J, halfBg, plan):
            return plan
    return 1, 1, 1, max(C for C in CLUSTERS if C <= max_cluster(N)), True, True, False


def kernel_plan(U: int, N: int, J: int, halfBg: int) -> tuple[int, int, int, int]:
    """The (samples, limbs a pass, digit rows a pass, blocks a cluster) that
    the launcher takes.  The instantiations' plans come first (``PLANS``,
    then row shares at 2 to 8 samples); else the general kernel's: per
    cluster size (1, 2, 4, 8, up to :func:`max_cluster`) and samples (8 down
    to 1), all J rows at 4 limbs and at 1 limb a pass, then 1 limb and the
    most rows that fit; else its staged tier (:func:`is_staged`), per
    cluster size and samples, 4 limbs and then 1 limb a pass at the most
    rows that fit; else, from N = ``GLOBAL_TILE`` on, the global tier
    (:func:`is_global`): 8 samples, 4 limbs and min(J, ``GLOBAL_ROWS``) rows
    a pass.  Every plan keeps a pass's limb sums in int32: over
    the whole ring (:func:`max_rows`), or, in the global tier, over a
    contraction chunk (:func:`chunk_rows`).  Where none fits: (1, 1, 1, the
    largest cluster), which the domain check refuses."""
    return _plan(U, N, J, halfBg)[:4]


def is_staged(U: int, N: int, J: int, halfBg: int) -> bool:
    """Whether the launcher takes the general kernel's staged tier: each
    share's digit rows computed from the step's accumulators and its
    products added into an update buffer, committed to acc after the last
    share, so that shared memory holds the share's digit rows alone.  It is
    taken only where no other plan fits."""
    return _plan(U, N, J, halfBg)[5]


def is_global(U: int, N: int, J: int, halfBg: int) -> bool:
    """Whether the launcher takes the global tier: the accumulators in device
    memory, (B, U, N) int32 (the output, updated in place), each step's
    digits written once to a device scratch (B, J, N) int8 by one kernel and
    a block of ``GLOBAL_SAMPLES`` samples and ``GLOBAL_TILE`` outputs of one
    polynomial streaming key windows and digit chunks through shared memory
    in a second, one launch of each a step.  It is taken only where no other
    plan fits (from N = 32768 on, where a sample's share of the accumulators
    outgrows a block of a cluster of 8)."""
    return _plan(U, N, J, halfBg)[6]


def scratch_bytes(B: int, U: int, N: int, J: int, halfBg: int) -> int:
    """Device scratch of a launch: the global tier's digits (B, J, N) int8;
    no other plan has any."""
    return B * J * N if is_global(U, N, J, halfBg) else 0


def check_kernel_domain(params: GateBootstrappingParams) -> None:
    """K2's domain (``csrc/blind_rotate_compact.cu``): raise ``ValueError``,
    naming the limit and the value, for a shape its launcher refuses."""
    check_digit_domain(params)
    tg = params.tgsw_params
    U, N, J = tg.tlwe_params.k + 1, tg.tlwe_params.N, tg.kpl
    where = f"(N={N}, k={U - 1}, l={tg.l}, Bgbit={tg.Bgbit})"
    if N & (N - 1) or N < 8:
        raise ValueError(f"K2 (blind_rotate_compact) takes N a power of two from 8; "
                         f"got N={N} {where}")
    if tg.l * tg.Bgbit > 32:
        raise ValueError(f"K2 (blind_rotate_compact) takes l*Bgbit <= 32 {where}")
    plan = _plan(U, N, J, tg.halfBg)
    if not _fits(U, N, J, tg.halfBg, plan):
        samples, limbs, rows, cluster, general, staged, _ = plan
        smem = smem_bytes(U, N, J, *plan[:4], general, staged)
        raise ValueError(f"K2 (blind_rotate_compact) needs {smem:,} bytes of shared memory "
                         f"for U={U}, N={N}, J={J} at {samples} samples, {limbs} key limb "
                         f"and {rows} digit row a pass in a cluster of {cluster} blocks; the "
                         f"card allows {SMEM_PER_BLOCK:,} {where}")


def check_rows_domain(params: GateBootstrappingParams) -> None:
    """Raise where the reference's "rows" form fails: its scan asserts that
    the int32 sum over all J digit rows and all N coefficients stays below
    2^31 (``ops/polymul.py:124``), J*N*halfBg*128 < 2^31, on every backend."""
    tg = params.tgsw_params
    J, N = tg.kpl, tg.tlwe_params.N
    if J * N * tg.halfBg * 128 >= 1 << 31:
        raise ValueError(f"the rows eval-key form's int32 sum reaches "
                         f"{J * N * tg.halfBg * 128:,} >= 2^31 (N={N}, J={J}, "
                         f"halfBg={tg.halfBg}), where the reference's rows scan asserts; "
                         f"use the fused (compact) form")


def prepare_compact_bk(bk_rows: torch.Tensor, limbs: int = polymul.LIMBS) -> torch.Tensor:
    """The stored key of the compact form: (n, kpl, k+1, N) int32.

    ``limbs == 4`` stores the true key.  ``limbs < 4`` is the reference's
    demoted rounded-key form: the key rounded (wrapping) to the nearest
    multiple of 2^(8*drop), drop = 4 - limbs, which is the key that the
    reference's kernel multiplies by when it keeps only the top limbs.
    """
    drop = polymul.LIMBS - limbs
    if not 0 <= drop < polymul.LIMBS:
        raise ValueError(f"limbs must be in 1..{polymul.LIMBS}, got {limbs}")
    if not drop:
        return bk_rows.contiguous()
    half = 1 << (8 * drop - 1)
    return wrap32((bk_rows.to(torch.int64) + half) & -(1 << (8 * drop))).contiguous()


def _shapes(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
            params: GateBootstrappingParams):
    check_digit_domain(params)
    B, U, N = acc0.shape
    n, J, U2, N2 = key.shape
    tg = params.tgsw_params
    if not (U == U2 == tg.tlwe_params.k + 1 and N == N2 == tg.tlwe_params.N
            and J == tg.kpl and tuple(bara.shape) == (n, B)):
        raise ValueError(f"shape mismatch: acc0 {tuple(acc0.shape)}, bara "
                         f"{tuple(bara.shape)}, key {tuple(key.shape)}")
    return B, U, N, n


#: From this N on the plain version multiplies by the exact CRT-NTT product
#: (``ntt.external_product_ntt`` over the step's rows transformed as they
#: come) instead of each row's negacyclic Toeplitz, whose float64 block (U N^2
#: words) is 4.3 GB a row at N = 16384 and the slower of the two from N = 4096.
NTT_PLAIN_FROM_N = 4096
#: From this N on that product runs over ``ntt.wide_context`` (three primes,
#: inner length 2048), where the "ntt_scan" form's context has no root.
WIDE_PLAIN_FROM_N = 32768


def plain_context(params: GateBootstrappingParams, device=None) -> ntt.NttContext:
    """The exact plan of the plain version's product from N =
    ``NTT_PLAIN_FROM_N`` on: the "ntt_scan" form's context over
    ``DEFAULT_PRIMES``, and from ``WIDE_PLAIN_FROM_N`` on ``ntt.wide_context``
    (the "ntt_scan" form keeps raising there, as the reference's does)."""
    tg = params.tgsw_params
    if tg.tlwe_params.N >= WIDE_PLAIN_FROM_N:
        return ntt.wide_context(tg.tlwe_params.N, tg.kpl, tg.halfBg, device=device)
    return ntt.context_for_params(params, device=device)


def cmux_rotate_step(acc: torch.Tensor, bk_row: torch.Tensor, bara_i: torch.Tensor,
                     params: GateBootstrappingParams, ctx: ntt.NttContext | None = None
                     ) -> torch.Tensor:
    """One CMux step (upstream ``tfhe_MuxRotate_FFT``):
    acc <- acc + bk_i (.) ((X^{bara_i} - 1) * acc).

    Args:
      acc: (..., k+1, N) int32; bk_row: (kpl, k+1, N) int32;
      bara_i: (...) int32 in [0, 2N); ctx: :func:`plain_context` for N >=
      ``NTT_PLAIN_FROM_N`` (made here if None).
    """
    tg = params.tgsw_params
    rot = rotate.mul_by_xai(acc, bara_i[..., None])
    d = wrap32(rot.to(torch.int64) - acc.to(torch.int64))
    digits = decompose_h(d, tg)
    if tg.tlwe_params.N >= NTT_PLAIN_FROM_N:
        ctx = plain_context(params, device=acc.device) if ctx is None else ctx
        key_step = ntt.kernel_key_residues(bk_row[None], ctx)[0]
        delta = ntt.external_product_ntt(digits.reshape(-1, *digits.shape[-2:]), key_step,
                                         ctx).reshape(acc.shape)
    else:
        delta = polymul.small_by_torus_matmul(digits, bk_row, x_bound=tg.halfBg)
    return wrap32(acc.to(torch.int64) + delta.to(torch.int64))


def blind_rotate_compact_plain(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                               params: GateBootstrappingParams) -> torch.Tensor:
    """Plain PyTorch blind rotation: the reference's rows scan
    (``core/bootstrap.blind_rotate``) over the stored key; from N =
    ``NTT_PLAIN_FROM_N`` on, each step's exact product through the CRT-NTT
    stages of :func:`plain_context` instead of the Toeplitz blocks (the same
    bits).

    Args:
      acc0: (B, k+1, N) int32; bara: (n, B) int32 in [0, 2N);
      key: (n, kpl, k+1, N) int32 from :func:`prepare_compact_bk`.
    Returns (B, k+1, N) int32.
    """
    _, _, N, n = _shapes(acc0, bara, key, params)
    ctx = plain_context(params, device=acc0.device) if N >= NTT_PLAIN_FROM_N else None
    acc = acc0
    for i in range(n):
        acc = cmux_rotate_step(acc, key[i], bara[i], params, ctx)
    return acc


def _check_device_memory(nbytes: int, device: torch.device, what: str) -> None:
    """Raise, naming K2 and the bytes, where the card cannot hold ``nbytes``
    more (the free memory and what PyTorch's allocator holds unused)."""
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    if nbytes > free:
        raise ValueError(f"K2 (blind_rotate_compact) needs {nbytes:,} bytes of device memory "
                         f"for {what}; the card has {free:,} free")


def _launch(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
            params: GateBootstrappingParams) -> torch.Tensor:
    global launches
    from ..kernels import build

    B, U, N, n = _shapes(acc0, bara, key, params)
    check_kernel_domain(params)
    for name, x in (("acc0", acc0), ("bara", bara), ("key", key)):
        if (x.device != acc0.device or x.dtype != torch.int32 or not x.is_contiguous()
                or x.data_ptr() % 4):
            raise ValueError(f"{name} must be a contiguous, 4-byte aligned int32 "
                             f"tensor on {acc0.device}, got {x.dtype} on {x.device}")
    tg = params.tgsw_params
    nscratch = scratch_bytes(B, U, N, tg.kpl, tg.halfBg)
    if nscratch:
        _check_device_memory(acc0.numel() * 4 + nscratch, acc0.device,
                             f"the global tier's accumulators (B={B}, U={U}, N={N}) and "
                             f"digits (J={tg.kpl})")
    out = torch.empty_like(acc0)
    scratch = torch.empty(nscratch, dtype=torch.int8, device=acc0.device)
    lib = build.load("blind_rotate_compact")
    stream = torch.cuda.current_stream(acc0.device).cuda_stream
    with torch.cuda.device(acc0.device):
        err = lib.blind_rotate_compact_launch(
            acc0.data_ptr(), bara.data_ptr(), key.data_ptr(), scratch.data_ptr(), nscratch,
            out.data_ptr(), B, n, U, N, tg.l, tg.Bgbit, stream)
    if err != 0:
        raise RuntimeError(f"blind_rotate_compact launch failed: CUDA error {err} "
                           f"({lib.kernel_error_string(err).decode()})")
    launches += 1
    return out


def blind_rotate_compact(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                         params: GateBootstrappingParams) -> torch.Tensor:
    """All n CMux steps of the blind rotation over the stored key.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (no
    fallback)."""
    if acc0.device.type == "cpu":
        return blind_rotate_compact_plain(acc0, bara, key, params)
    if acc0.device.type != "cuda":
        raise ValueError(f"unsupported device {acc0.device}")
    return _launch(acc0, bara, key, params)
