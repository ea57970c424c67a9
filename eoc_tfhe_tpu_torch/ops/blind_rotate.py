"""The blind rotation over the NTT-domain key: CUDA kernel and plain version.

Replaces the TPU kernel ``eoc_tfhe_tpu/ops/pallas_ntt_blindrot2.py``
(``blind_rotate_ntt_pallas2``, its ``pallas_call`` at line 648).  Its
contract is the reference's output bits: each CMux step adds the exact
negacyclic product  sum_j digits_j (*) bk[i, j, u]  mod 2^32, so any exact
dataflow gives the same bits.

:func:`blind_rotate_ntt` is the wrapper.  For a tensor on the CPU it runs
:func:`blind_rotate_ntt_plain`; for a CUDA tensor it launches the
hand-written int8 tensor-core kernel in ``csrc/blind_rotate_ntt.cu`` or
raises: :func:`check_kernel_domain` refuses, by name and before any launch,
a shape the kernel does not take.  ``launches`` counts kernel launches and
nothing else, ``cluster_launches`` those that took the narrow tier (a batch
whose sample groups leave most SMs idle: :func:`narrow_plan`).  The key is
``ntt.prepare_kernel_key``'s byte planes; the plain version reads the same
key.
"""

from __future__ import annotations

import torch

from ..core.numeric import wrap32
from ..core.tgsw import decompose_h
from . import rotate
from .ntt import NttContext, external_product_ntt, pad16, unpack_kernel_key

#: Number of launches of the CUDA kernel in this process, and of those that
#: took the narrow tier (:func:`narrow_plan`).
launches = 0
cluster_launches = 0

#: Shared memory a block may use on the H100 (its opt-in limit per block),
#: and its streaming multiprocessors (``cudaDevAttrMultiProcessorCount``).
SMEM_PER_BLOCK = 232_448
SMS = 132


def cmux_ntt_step(acc: torch.Tensor, key_step: torch.Tensor, bara_i: torch.Tensor,
                  ctx: NttContext, params) -> torch.Tensor:
    """One CMux step over the NTT-domain key: acc + bk_i (.) ((X^a - 1) acc),
    the external product by the stages of ``ntt.external_product_ntt`` (the
    ``ops/ntt.py`` algorithm of the reference in torch).

    Args:
      acc: (B, k+1, N) int32; key_step: (P, F, K, M) int16; bara_i: (B,) int32.
    """
    rot = rotate.mul_by_xai(acc, bara_i[:, None])
    d = wrap32(rot.to(torch.int64) - acc.to(torch.int64))
    delta = external_product_ntt(decompose_h(d, params.tgsw_params), key_step, ctx)
    return wrap32(acc.to(torch.int64) + delta.to(torch.int64))


def kernel_key_shapes(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                      ctx: NttContext, params):
    """Check a rotation's shapes against the plan for the packed key
    (n, P, F, Mp/16, Kp/16, 32, 16); returns (B, U, N, n)."""
    B, U, N = acc0.shape
    tg = params.tgsw_params
    K, M = tg.kpl * ctx.R, ctx.key_limbs * U * ctx.R
    n = key.shape[0]
    ok = (key.dim() == 7 and N == ctx.N
          and tuple(key.shape[1:]) == (2, ctx.F, pad16(M) // 16, pad16(K) // 16, 32, 16)
          and len(ctx.primes) == 2 and tg.kpl == U * tg.l and U == tg.tlwe_params.k + 1
          and tuple(bara.shape) == (n, B))
    if not ok:
        raise ValueError(f"shape mismatch: acc0 {tuple(acc0.shape)}, bara "
                         f"{tuple(bara.shape)}, key {tuple(key.shape)}")
    return B, U, N, n


def blind_rotate_ntt_plain(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                           ctx: NttContext, params) -> torch.Tensor:
    """Plain PyTorch blind rotation (``ops/ntt.blind_rotate_ntt`` of the
    reference): each step's int16 residues are rebuilt from the key's byte
    planes.

    Args:
      acc0: (B, k+1, N) int32; bara: (n, B) int32 in [0, 2N);
      key: (n, P, F, Mp/16, Kp/16, 32, 16) int8 from ``ntt.prepare_kernel_key``.
    Returns (B, k+1, N) int32.
    """
    B, U, N, n = kernel_key_shapes(acc0, bara, key, ctx, params)
    K, M = params.tgsw_params.kpl * ctx.R, ctx.key_limbs * U * ctx.R
    acc = acc0
    for i in range(n):
        acc = cmux_ntt_step(acc, unpack_kernel_key(key[i], K, M), bara[i], ctx, params)
    return acc


def check_operands(acc0: torch.Tensor, operands) -> None:
    """Raise unless each (name, tensor, dtype) is a contiguous, 16-byte
    aligned tensor of that dtype on acc0's device."""
    for arg, x, dt in operands:
        if (x.device != acc0.device or x.dtype != dt or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"{arg} must be a contiguous, 16-byte aligned {dt} "
                             f"tensor on {acc0.device}, got {x.dtype} on {x.device}")


def launch_error(name: str, lib, err: int) -> RuntimeError:
    return RuntimeError(f"{name} launch failed: CUDA error {err} "
                        f"({lib.kernel_error_string(err).decode()})")


#: Samples a ``crt_ntt_mma.cuh`` block (or cluster) holds: 8 (the pointwise
#: MMA's N), or 4, 2 or 1 where 8 do not fit in shared memory.
SAMPLES = (8, 4, 2, 1)
#: Blocks a cluster of the cluster instantiation (``crt_mma::kMaxCluster``:
#: the portable limit), and the most frequencies one block holds
#: (``kMaxClusterF``: F up to 512 without a cluster).
CLUSTERS = (2, 4, 8)
MAX_BLOCK_F = 512
#: The stream tier (``crt_mma::rotate_kernel_stream``): frequencies a
#: sub-chunk (fs = 8 * n8 tiles, at most 16 tiles: one a warp or fewer), the
#: forward's (m-tile, n8 tile) accumulators a warp holds (``kStreamTiles``),
#: and the digit slabs in flight (two where they fit, else one).
STREAM_FS = (128, 64, 32, 16, 8)
STREAM_TILES = 8
STREAM_SLABS = (2, 1)


#: The narrow tier (``crt_mma::rotate_kernel_narrow``, K1 alone): blocks a
#: cluster, the largest first (16 is the card's non-portable size), and key
#: slots of one prime-step each (four: the next step's key in flight while
#: this step's is read; else two).
NARROW_CLUSTERS = (16, 8, 4, 2)
NARROW_SLOTS = (4, 2)


def kernel_scratch_bytes(B: int, U: int, ctx: NttContext, tg, samples: int,
                         cluster: int = 1, narrow: bool = False) -> int:
    """Device scratch of the kernels on ``crt_ntt_mma.cuh`` (K1, K3): per block
    of ``samples`` samples (``cluster`` blocks for each ``samples``), the first
    prime's inverse residues (samples, Mp, F/cluster, at least 8) int16 and the
    digits (DL, samples, Kp, FP + 16) int8, each rounded up to 16 bytes; none
    for the narrow tier (``narrow``), which keeps both on the chip."""
    if narrow:
        return 0
    Kp, Mp, F = pad16(tg.kpl * ctx.R), pad16(ctx.key_limbs * U * ctx.R), ctx.F
    DL = 1 if tg.halfBg <= 128 else 2
    per_block = (-(-samples * Mp * max(F // cluster, 8) * 2 // 16) * 16
                 + -(-DL * samples * Kp * (max(F, 32) + 16) // 16) * 16)
    return -(-B // samples) * cluster * per_block


def crt_mma_smem_bytes(U: int, ctx: NttContext, tg, stage_bytes: int, samples: int,
                       cluster: int = 1, stream: tuple[int, int] | None = None) -> int:
    """Shared memory of a ``crt_ntt_mma.cuh`` block of ``samples`` samples:
    dig and chat in one buffer, dhat, and ``stage_bytes`` per warp (16 warps)
    for a key that is transposed on the chip.  In a cluster of ``cluster``
    blocks each block holds the whole samples' digits but chat and dhat of
    its F/cluster frequencies alone.  The stream tier (``stream`` = (fs,
    slabs), one sample) holds chat of its F/cluster frequencies, dhat of fs
    of them, ``slabs`` digit slabs of DL*Kp*32 bytes and the staging tiles:
    the digits stay in the device scratch."""
    Kp, Mp, F = pad16(tg.kpl * ctx.R), pad16(ctx.key_limbs * U * ctx.R), ctx.F
    DL = 1 if tg.halfBg <= 128 else 2
    DS = max(F, 32) + 16
    Fc = F // cluster
    DSc = DS if cluster == 1 else Fc + 16
    if stream is not None:
        fs, slabs = stream
        chat = -(-2 * Mp * DSc // 16) * 16
        dhat = -(-fs * (2 * Kp + 16) // 16) * 16
        return chat + dhat + slabs * DL * Kp * 32 + 16 * stage_bytes
    buf1 = -(-max(DL * samples * Kp * DS, 2 * samples * Mp * DSc) // 16) * 16
    return buf1 + Fc * (2 * samples * Kp + 16) + 16 * stage_bytes


def _plan(U: int, ctx: NttContext, tg, stage_bytes: int):
    """(samples, general, cluster, stream): see :func:`crt_mma_plan` and
    :func:`crt_mma_stream`."""
    Kp, F = pad16(tg.kpl * ctx.R), ctx.F
    smem = {s: crt_mma_smem_bytes(U, ctx, tg, stage_bytes, s) for s in SAMPLES}
    general = (max(F, 32) > 128 or Kp > 64 or ctx.key_round_bits > 0 or F < 8
               or smem[8] > SMEM_PER_BLOCK)
    if not general:
        return 8, False, 1, None
    fits = [s for s in SAMPLES if smem[s] <= SMEM_PER_BLOCK]
    if fits and F <= MAX_BLOCK_F:
        return fits[0], True, 1, None
    tried = [C for C in CLUSTERS if F % (32 * C) == 0 and F // C <= MAX_BLOCK_F]
    for C in tried:
        fit = [s for s in SAMPLES
               if crt_mma_smem_bytes(U, ctx, tg, stage_bytes, s, C) <= SMEM_PER_BLOCK]
        if fit:
            return fit[0], True, C, None
    for C in tried:
        for fs in STREAM_FS:
            if fs > F // C or Kp // 16 * fs // 8 > 16 * STREAM_TILES:
                continue
            for slabs in STREAM_SLABS:
                if crt_mma_smem_bytes(U, ctx, tg, stage_bytes, 1, C,
                                      (fs, slabs)) <= SMEM_PER_BLOCK:
                    return 1, True, C, (fs, slabs)
    return 1, True, tried[-1] if tried else 1, None


def narrow_exchange(U: int, ctx: NttContext, samples: int, cluster: int) -> dict:
    """What a block of the narrow tier receives a step on each of its two
    mbarriers (``crt_mma::rotate_kernel_narrow``): ``{"acc": (bytes armed,
    pieces), "chat": (bytes armed, pieces)}``, each piece (sender's rank,
    byte offset in the receiving buffer, bytes) a bulk copy that completes on
    it.  "acc": from each owner c and sample s, c's slice of the sample (P
    pairs (u, r) of F uint32, P = U R / cluster) at its place in the r-major
    accumulator (samples, U, R, F); armed for the whole accumulator.  "chat":
    from each sender c, its share for this block, (2 primes, samples L P
    rows, lo and hi planes, Fc = F/cluster frequencies) int8, at c times the
    share; armed for the block's rows over both primes, both planes and all
    F frequencies."""
    F, R = ctx.F, ctx.R
    Fc, pairs = F // cluster, U * R // cluster
    rows = samples * ctx.key_limbs * pairs
    share = 2 * rows * 2 * Fc
    acc = [(c, (s * U * R + c * pairs) * F * 4, pairs * F * 4)
           for s in range(samples) for c in range(cluster)]
    chat = [(c, c * share, share) for c in range(cluster)]
    return {"acc": (samples * U * ctx.N * 4, acc), "chat": (2 * rows * 2 * F, chat)}


def narrow_smem_bytes(U: int, ctx: NttContext, tg, samples: int, cluster: int,
                      slots: int, winv: bool = False) -> int:
    """Shared memory of a block of the narrow tier (``crt_mma::plan_narrow``):
    ``slots`` key shares of a prime and step (Fc (Mp/16) (Kp/16) 512 bytes,
    Fc = F/cluster); the pushed accumulator (samples, U, N) uint32; the
    digits (DL, samples, Kp, F + 16) int8 or, in the same bytes, chat staged
    by owner and after it the inverse residues (2, 8 nr, F) int16, nr the n8
    tiles of the block's rows (samples x L P rows, P = U R / cluster pairs
    (u, r) a block); the block's slice of the accumulator (samples, P, F)
    uint32; dhat of both primes (2, Fc, 2 samples Kp + 16) int8; chat
    received by sender; each chat buffer the bytes armed on "chat"
    (:func:`narrow_exchange`); an 8-byte mbarrier a slot, two more ("acc",
    "chat") and bara of two steps (2, 8) int32; with ``winv``, the inverse's
    fragments of both primes (``NttContext.Winv_mma``, 8 F^2 bytes), staged
    once a launch."""
    Kp, Mp, F = pad16(tg.kpl * ctx.R), pad16(ctx.key_limbs * U * ctx.R), ctx.F
    DL = 1 if tg.halfBg <= 128 else 2
    Fc, pairs = F // cluster, U * ctx.R // cluster
    nr = -(-samples * ctx.key_limbs * pairs // 8)
    ex = narrow_exchange(U, ctx, samples, cluster)
    chat = ex["chat"][0]
    return (slots * Fc * (Mp // 16) * (Kp // 16) * 512 + ex["acc"][0]
            + max(DL * samples * Kp * (F + 16), chat + 32 * nr * F) + samples * pairs * F * 4
            + 2 * Fc * (2 * samples * Kp + 16) + chat
            + 8 * (slots + 2) + 2 * SAMPLES[0] * 4 + (8 * F * F if winv else 0))


def narrow_plan(B: int, U: int, ctx: NttContext, tg, sms: int = SMS,
                clusters=None) -> tuple[int, int, int, bool] | None:
    """(samples a cluster, blocks a cluster, key slots, Winv staged) of K1's
    narrow tier for a batch of B, or None where it is not taken (``crt_mma::
    plan_narrow_tier``).  Only the shipped instantiations' shapes with F >= 32
    (every k32 column of the inverse then has an owning block) take it.  The
    cluster is the largest C of ``NARROW_CLUSTERS`` (F/C a multiple of 8, C
    dividing U R: each block owns U R / C pairs (u, r)) for which some
    samples of 1, 2, 4, 8 (the fewest first, so that the most clusters run
    side by side; at most the power of two that holds B) gives G = ceil(B /
    samples) groups with G C <= ``sms``, blocks that fit with two slots (more
    samples need more: the next C then), and G clusters that the card holds
    at once, ``clusters(C, smem)`` (the launcher's
    ``cudaOccupancyMaxActiveClusters``; ``sms // C`` where not given); then
    the first that fits of four slots and Winv staged, two slots and Winv,
    four slots, two (``NARROW_SLOTS``)."""
    if ctx.F < 32 or crt_mma_plan(U, ctx, tg)[1]:
        return None
    top = min(SAMPLES[0], 1 << (B - 1).bit_length())
    for C in NARROW_CLUSTERS:
        if ctx.F % (8 * C) or U * ctx.R % C:
            continue
        for samples in sorted(s for s in SAMPLES if s <= top):
            G = -(-B // samples)
            if G * C > sms:
                continue
            smem = narrow_smem_bytes(U, ctx, tg, samples, C, NARROW_SLOTS[-1])
            if smem > SMEM_PER_BLOCK:
                break
            if (sms // C if clusters is None else clusters(C, smem)) < G:
                continue
            return next((samples, C, n, w) for w in (True, False) for n in NARROW_SLOTS
                        if narrow_smem_bytes(U, ctx, tg, samples, C, n, w) <= SMEM_PER_BLOCK)
    return None


def crt_mma_plan(U: int, ctx: NttContext, tg, stage_bytes: int = 0, batch: int | None = None,
                 sms: int = SMS, clusters=None) -> tuple[int, bool, int]:
    """The instantiation ``crt_mma::launch`` picks: (samples a block or
    cluster, general, blocks a cluster).  With ``batch`` (K1's launches: the
    narrow tier reads the packed key), a batch that :func:`narrow_plan` takes
    gives (its samples a cluster, False, its blocks a cluster); every other
    plan is independent of the batch.

    The shipped sets (F <= 128, Kp <= 64, an exact key, 8 samples within the
    card's shared memory) take their compile-time instantiations; every
    other shape (F = 4 and Kp > 256 too), and every rounded plan (rb > 0),
    takes the general one at the most samples that fit.  Where one sample
    does not fit a block, or F > 512, the cluster instantiation takes it: the
    fewest blocks a cluster (2, 4 or 8; F/C a multiple of 32 and at most 512)
    that hold one sample, at the most samples that fit.  Where its digits do
    not fit either, the stream tier takes one sample (:func:`crt_mma_stream`).
    Where nothing fits, the plan is (1, True, the largest cluster tried, or
    1), which the domain check refuses.
    """
    narrow = None if batch is None else narrow_plan(batch, U, ctx, tg, sms, clusters)
    if narrow is not None:
        return narrow[0], False, narrow[1]
    return _plan(U, ctx, tg, stage_bytes)[:3]


def crt_mma_stream(U: int, ctx: NttContext, tg,
                   stage_bytes: int = 0) -> tuple[int, int, int] | None:
    """(blocks a cluster, frequencies a sub-chunk, digit slabs) of the stream
    tier where ``crt_mma::launch`` takes it, else None.  It is taken only
    where no other plan fits (ROADMAP C11): one sample in a cluster of 2, 4
    or 8 blocks split by frequency as in the cluster instantiation, the
    step's digits written once to the device scratch, and each block's F/C
    frequencies walked in sub-chunks of fs, each with the forward for all Kp
    rows from digit slabs streamed through shared memory, the pointwise
    product over the whole Kp and its chat stored.  The first fit of, per
    cluster size (the fewest blocks first), fs from 128 down (at most 16
    n8 tiles, and Kp/16 * fs/8 forward tiles within ``STREAM_TILES`` a warp)
    and two slabs, then one."""
    _, _, cluster, stream = _plan(U, ctx, tg, stage_bytes)
    return None if stream is None else (cluster, *stream)


def _c16(p: int) -> int:
    """|2^16 mod p|, balanced: the pointwise stage's factor of C2."""
    r = (1 << 16) % p
    return abs(r - p if r > p // 2 else r)


def crt_mma_sums(U: int, ctx: NttContext, tg, *, reduce_c2: bool,
                 stage_bytes: int = 0) -> dict[str, int]:
    """Worst-case magnitudes of the int32 sums of ``crt_mma::launch``'s
    stages in the instantiation it picks (the launcher's bounds): the forward
    (C1 reduced before its product by 256 at F = 512 and in a cluster), the
    pointwise (C2 reduced for a ``reduce_c2`` key and in the general and
    cluster instantiations, C1 too there at Kp > 128) and the inverse (C1
    reduced at F >= 256 and in a cluster, where each block contracts over
    all F through DSMEM).  The stream tier runs in a cluster with the
    general pointwise stage, so the same bounds hold: its forward sums a
    sub-chunk's tiles over all of FP, slab by slab, in one accumulator, and
    its pointwise sum runs over the whole Kp of one frequency at once."""
    Kp, FP = pad16(tg.kpl * ctx.R), max(ctx.F, 32)
    hmax = max((p - 1) // 2 for p in ctx.primes)
    dhi = 0 if tg.halfBg <= 128 else -(-tg.halfBg // 256)
    c16_half = max(_c16(p) * ((p - 1) // 2) for p in ctx.primes)
    _, general, cluster = crt_mma_plan(U, ctx, tg, stage_bytes)
    if general and Kp > 128:
        pointwise = Kp * 128 * 128 + 256 * hmax + c16_half
    elif reduce_c2 or general:
        pointwise = Kp * 128 * 128 * 513 + c16_half
    else:
        pointwise = Kp * 128 * 128 * (513 + max(_c16(p) for p in ctx.primes))
    forward = (FP * 128 * (128 + dhi) + 256 * hmax if FP > 256 or cluster > 1
               else 257 * FP * 128 * (128 + dhi))
    inverse = (FP * 2 * 128 * 128 + 256 * hmax if FP > 128 or cluster > 1
               else 257 * FP * 2 * 128 * 128)
    return {"forward": forward, "pointwise": pointwise, "inverse": inverse}


def check_crt_mma_domain(name: str, U: int, ctx: NttContext, tg, *, reduce_c2: bool,
                         stage_bytes: int) -> None:
    """Raise ``ValueError``, naming the limit and the value, for a shape that
    ``crt_mma::launch`` refuses: its launcher's conditions, shared memory
    included, in Python, so that the refusal comes before any launch.
    ``reduce_c2`` and ``stage_bytes`` are the key loader's ``kReduceC2`` and
    ``kStageBytes``; the general instantiation reduces C2 for every key."""
    N, R, F, L, kbits = ctx.N, ctx.R, ctx.F, ctx.key_limbs, ctx.key_limb_bits
    rb = ctx.key_round_bits
    K, M = tg.kpl * ctx.R, L * U * R
    p0, p1 = ctx.primes
    half0, half1 = (p0 - 1) // 2, (p1 - 1) // 2

    def refuse(what):
        raise ValueError(f"{name} {what} (N={N}, k={U - 1}, l={tg.l}, Bgbit={tg.Bgbit}, "
                         f"primes {ctx.primes})")

    top = CLUSTERS[-1] * MAX_BLOCK_F
    if (F % 8 and F != 4) or not 4 <= F <= top:
        refuse(f"takes F = N/R = 4 or a multiple of 8 up to {top}; N={N}, R={R} give F={F}")
    if tg.Bgbit > 15 or tg.l * tg.Bgbit > 32:
        refuse(f"takes Bgbit <= 15 and l*Bgbit <= 32; got Bgbit={tg.Bgbit}, l={tg.l}")
    if not 0 <= rb < 32 or L * kbits < 32 - rb or kbits * (L - 1) >= 32 - rb:
        refuse(f"takes key limbs covering 32 - rb bits once; got {L} x {kbits} bits, rb={rb}")
    if min(p0, p1) < 1024 or not (p0 & p1 & 1) or max(half0, half1) > 127 * 256 + 127:
        refuse(f"takes odd primes from 1024 to 65279; got {ctx.primes}")
    samples, general, cluster, stream = _plan(U, ctx, tg, stage_bytes)
    smem = crt_mma_smem_bytes(U, ctx, tg, stage_bytes, samples, cluster, stream)
    if smem > SMEM_PER_BLOCK:
        refuse(f"needs {smem:,} bytes of shared memory for U={U}, N={N}, K={K}, M={M} "
               f"at {samples} samples a block"
               + (f" in a cluster of {cluster} blocks" if cluster > 1 else "")
               + f"; the card allows {SMEM_PER_BLOCK:,}")
    for stage, bound in crt_mma_sums(U, ctx, tg, reduce_c2=reduce_c2,
                                     stage_bytes=stage_bytes).items():
        if bound >= 1 << 31:
            refuse(f"{stage} int32 sum reaches {bound:,} >= 2^31 (Kp={pad16(K)}, F={F}, "
                   f"c16 = {_c16(p0)}, {_c16(p1)}"
                   f"{', C2 reduced' if reduce_c2 or general else ''})")
    if (half0 + half1) * abs(ctx.crt_inv) >= 1 << 31 or half1 * p0 + half0 >= 1 << 31:
        refuse(f"CRT sums leave int32 for primes {ctx.primes}")


def check_kernel_domain(U: int, ctx: NttContext, tg) -> None:
    """K1's domain (``csrc/blind_rotate_ntt.cu``): raise ``ValueError``, by
    name, for a shape its launcher refuses."""
    check_crt_mma_domain("K1 (blind_rotate_ntt)", U, ctx, tg, reduce_c2=False, stage_bytes=0)


#: K1's plans on a card, by batch, shape and device (:func:`launch_plan`).
_PLANS: dict = {}


def launch_plan(B: int, U: int, ctx: NttContext, tg, device: torch.device) -> tuple[int, bool, int]:
    """:func:`crt_mma_plan` of a K1 launch of B samples on ``device``, its SM
    count and cluster occupancy read from the card (memoised: one dictionary
    lookup after the first).  CPU tensors take the plain version: (0, False,
    1) there."""
    if device.type != "cuda":
        return 0, False, 1
    at = (B, U, ctx.N, ctx.R, ctx.key_limbs, ctx.key_limb_bits, ctx.key_round_bits, ctx.primes,
          tg.l, tg.Bgbit, device.index)
    plan = _PLANS.get(at)
    if plan is None:
        DL = 1 if tg.halfBg <= 128 else 2
        plan = _PLANS[at] = crt_mma_plan(
            U, ctx, tg, batch=B, sms=torch.cuda.get_device_properties(device).multi_processor_count,
            clusters=lambda C, smem: _narrow_clusters(device, DL, C, smem))
    return plan


def cluster_blocks(acc0: torch.Tensor, ctx: NttContext, params) -> int:
    """Blocks a cluster of the K1 launch that rotates ``acc0`` (1 off the
    narrow tier and the cluster instantiations, and on the CPU)."""
    tg = params.tgsw_params
    return launch_plan(acc0.shape[0], acc0.shape[1], ctx, tg, acc0.device)[2]


def _narrow_clusters(device: torch.device, DL: int, C: int, smem: int) -> int:
    """The launcher's ``cudaOccupancyMaxActiveClusters`` of the narrow tier."""
    import ctypes

    from ..kernels import build

    lib = build.load("blind_rotate_ntt")
    fn = lib.blind_rotate_ntt_narrow_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(DL, C, smem, ctypes.byref(out))
    if err != 0:
        raise launch_error("blind_rotate_ntt_narrow_clusters", lib, err)
    return out.value


def _launch(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
            ctx: NttContext, params) -> tuple[torch.Tensor, bool]:
    """Launch ``csrc/blind_rotate_ntt.cu`` on CUDA tensors and return its
    output and whether it took the narrow tier; raises on a bad operand or a
    refused launch."""
    from ..kernels import build

    B, U, N, n = kernel_key_shapes(acc0, bara, key, ctx, params)
    tg = params.tgsw_params
    check_kernel_domain(U, ctx, tg)
    check_operands(acc0, (("acc0", acc0, torch.int32), ("bara", bara, torch.int32),
                           ("key", key, torch.int8), ("W_mma", ctx.W_mma, torch.int8),
                           ("Winv_mma", ctx.Winv_mma, torch.int8)))
    out = torch.empty_like(acc0)
    samples, general, cluster = launch_plan(B, U, ctx, tg, acc0.device)
    narrow = cluster > 1 and not general
    scratch = torch.empty(kernel_scratch_bytes(B, U, ctx, tg, samples, cluster, narrow),
                          dtype=torch.uint8, device=acc0.device)
    lib = build.load("blind_rotate_ntt")
    stream = torch.cuda.current_stream(acc0.device).cuda_stream
    with torch.cuda.device(acc0.device):
        err = lib.blind_rotate_ntt_launch(
            acc0.data_ptr(), bara.data_ptr(), key.data_ptr(), ctx.W_mma.data_ptr(),
            ctx.Winv_mma.data_ptr(), scratch.data_ptr(), scratch.numel(), out.data_ptr(),
            B, n, U, N, ctx.R, tg.l, tg.Bgbit, ctx.key_limbs, ctx.key_limb_bits,
            ctx.key_round_bits, ctx.primes[0], ctx.primes[1], ctx.crt_inv, stream)
    if err != 0:
        raise launch_error("blind_rotate_ntt", lib, err)
    return out, narrow


def blind_rotate_ntt(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                     ctx: NttContext, params) -> torch.Tensor:
    """All n CMux steps of the blind rotation.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (no fallback)."""
    global launches, cluster_launches
    if acc0.device.type == "cpu":
        return blind_rotate_ntt_plain(acc0, bara, key, ctx, params)
    if acc0.device.type != "cuda":
        raise ValueError(f"unsupported device {acc0.device}")
    out, narrow = _launch(acc0, bara, key, ctx, params)
    launches += 1
    cluster_launches += narrow
    return out
