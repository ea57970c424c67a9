"""Sharded bootstrapped-gate execution with explicit collectives.

Port of ``eoc_tfhe_tpu/parallel/sharded.py`` onto ``torch.distributed``:
each ``shard_map`` body is the code of one rank, on its own slice, and its
collectives over "dp" and "tp" are the mesh's (``parallel/mesh.py``).

  * blind rotation — local per dp slice (no collectives; the key whole on
    every rank): ``bootstrap_woKS`` on the eval key as
    ``FrameworkConfig.prepare_eval_key`` gives it, so on the card every rank
    launches the form's kernel (K1 for "ntt"), or, where the reference's
    compact rows are given, kernel K2 (``ops/blind_rotate_compact``);
  * key switching — the (n_in*t*base) contraction rows are cut over tp; each
    rank contracts its row slice and the partial results are summed over tp
    exactly mod 2^32 (at tp = 1 an eval key's gate runs the one-card
    ``keyswitch_apply``);
  * the TGSW-row and the frequency split of the external product over tp,
    on the "ntt_scan" key's residues, with a sum, or an all_to_all and an
    all_gather, in every CMux step.  A fused n-step kernel cannot split a
    step across ranks, so these run the external product as torch ops
    (``ops/ntt.py``), as the reference runs them as XLA ops.

Calling convention.  The ciphertext batch is passed whole and equal on every
rank; each rank takes its dp slice (``shard_map``'s in_specs ``P("dp")``) and
the result comes back whole on every rank (an all_gather over dp for the
out_specs ``P("dp")``).  A key cut over tp is passed as this rank's block
(:class:`~.mesh.Sharded`, from :func:`shard_ntt_key_rows` or
:func:`shard_ntt_key_freq`), so each rank holds 1/tp of it; the keyswitch
table is passed whole and sliced here.

Spans (``utils/profiling.span``): ``tfhe.parallel.inputs dp= rank=`` around
this rank's dp slice and the gate's linear combination, and
``tfhe.parallel.gather dp= bytes=`` around the output's all_gather over dp
and its concatenation (``bytes``: this rank's slice of the output); the
collectives inside open their own (``parallel/mesh``).
"""

from __future__ import annotations

import torch

from ..core import gates
from ..core.bootstrap import (EvalKey, blind_rotate_inputs, blind_rotate_output_variance,
                              bootstrap_woKS, check_rotation_impl)
from ..core.lwe import LweCiphertext
from ..core.numeric import wrap32
from ..core.params import GateBootstrappingParams
from ..core.tgsw import decompose_h
from ..core.tlwe import TLweCiphertext, tlwe_extract_lwe_sample
from ..ops import blind_rotate_compact, ntt, rotate
from ..ops.keyswitch import keyswitch_apply, keyswitch_delta, keyswitch_digits, round_variance
from ..utils.profiling import span
from .mesh import Mesh, Sharded, batch_slice, shard


def _keyswitch_tp(u: LweCiphertext, ks_prepared: torch.Tensor, ks_variance,
                  t: int, basebit: int, n_in: int, mesh: Mesh,
                  axis: str = "tp") -> LweCiphertext:
    """Row-sharded keyswitch: local contraction over an i-slice + exact sum.

    ks_prepared: (n_in * t * base, m * LIMBS) float32, the whole table of
    ``ops.keyswitch.prepare_keyswitch_matmul``; its rows are i-major, so this
    rank's slice of the input coefficients i is a contiguous block of rows.
    """
    base = 1 << basebit
    ntp, idx = mesh.size(axis), mesh.index(axis)
    if n_in % ntp:
        raise ValueError(f"n_in={n_in} does not split over {axis}={ntp}")
    n_local = n_in // ntp
    rows = n_local * t * base
    table = ks_prepared[idx * rows:(idx + 1) * rows]

    digits = keyswitch_digits(u.a[..., idx * n_local:(idx + 1) * n_local], t, basebit)
    delta = mesh.psum(keyswitch_delta(digits, table, base), axis).to(torch.int64)
    n_out = delta.shape[-1] - 1
    a = wrap32(-delta[..., :n_out])
    b = wrap32(u.b.to(torch.int64) - delta[..., n_out])
    # Variance parity with ops/keyswitch.keyswitch_apply: the nonzero digits
    # counted over the tp row slices (integers: exact in float32 in any
    # order), plus the same digit-rounding term.
    nnz = mesh.psum((digits != 0).to(torch.float32).sum(dim=(-2, -1)), axis)
    var = u.current_variance + nnz * ks_variance + round_variance(n_in, t, basebit, nnz.device)
    return LweCiphertext(a=a, b=b, current_variance=var)


def _f32(x, device) -> torch.Tensor:
    """A variance (float or tensor) as a float32 scalar tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _dp_inputs(mesh: Mesh, offset_t32, sa, sb, ca_a, ca_b, ca_var, cb_a, cb_b, cb_var):
    """This rank's dp slice of the gate's bootstrap input (0, offset) + sa*ca + sb*cb."""
    with span("tfhe.parallel.inputs", dp=mesh.dp, rank=mesh.rank):
        ca = LweCiphertext(*(batch_slice(x, mesh) for x in (ca_a, ca_b, ca_var)))
        cb = LweCiphertext(*(batch_slice(x, mesh) for x in (cb_a, cb_b, cb_var)))
        return gates.linear_input(offset_t32, ca, cb, sa, sb)


def _dp_outputs(out: LweCiphertext, mesh: Mesh):
    parts = (out.a, out.b, out.current_variance)
    with span("tfhe.parallel.gather", dp=mesh.dp,
              bytes=sum(x.numel() * x.element_size() for x in parts)):
        return tuple(mesh.all_gather(x, "dp", 0) for x in parts)


def make_sharded_gate(mesh: Mesh, params: GateBootstrappingParams,
                      offset_t32: int, sa: int, sb: int,
                      rotation_impl: str = "auto"):
    """Build a sharded two-input bootstrapped gate (e.g. NAND).

    Returns fn(ca_a, ca_b, ca_var, cb_a, cb_b, cb_var, key) -> (a, b, var),
    the ciphertext batch sharded over dp and the keyswitch contraction over
    tp.  ``key`` is this rank's eval key as ``FrameworkConfig.prepare_eval_key``
    gives it, in any form: each rank bootstraps its dp slice through
    ``bootstrap_woKS`` on it (K1 for "ntt", at halfBg = 512 too).

    The reference's signature stays: fn(ca_a, ca_b, ca_var, cb_a, cb_b,
    cb_var, bk_rows, bk_var, ks_prepared, ks_var), the compact key's TGSW
    rows (the reference's "rows" key) in ``key``'s place, rotated by K2.
    The rows' int8 digits are exact only for halfBg <= 128 (ROADMAP C1):
    other sets are refused when rows are given.

    The variance rail matches the unsharded path bit for bit: input
    variances propagate through the linear part, the bootstrap term uses the
    real bk variance, and the keyswitch term counts nonzero digits; the
    static gate budget rail runs at build time like ``gates._gate``.
    """
    n_in = params.N * params.k
    gates.check_noise_budget(params, sa, sb)
    check_rotation_impl(rotation_impl)

    def gate_fn(ca_a, ca_b, ca_var, cb_a, cb_b, cb_var, key, bk_var=None,
                ks_prepared=None, ks_var=None):
        if isinstance(key, EvalKey):
            if (bk_var, ks_prepared, ks_var) != (None, None, None):
                raise ValueError("an EvalKey carries its variances and keyswitch table: "
                                 "pass it alone")
            temp = _dp_inputs(mesh, offset_t32, sa, sb, ca_a, ca_b, ca_var, cb_a, cb_b, cb_var)
            u = bootstrap_woKS(gates.MU_BOOL, temp, key, params, rotation_impl)
            if mesh.tp == 1:
                out = keyswitch_apply(u, key.ks, t=params.ks.t, basebit=params.ks.basebit,
                                      prepared=key.ks_prepared)
            else:
                out = _keyswitch_tp(u, key.ks_prepared, key.ks.variance, params.ks.t,
                                    params.ks.basebit, n_in, mesh)
            return _dp_outputs(out, mesh)
        blind_rotate_compact.check_digit_domain(params)
        temp = _dp_inputs(mesh, offset_t32, sa, sb, ca_a, ca_b, ca_var, cb_a, cb_b, cb_var)
        dev = mesh.device
        bk_rows = key.to(dev).contiguous()
        ek_local = EvalKey(bk_rows=bk_rows, bk_variance=_f32(bk_var, dev),
                           ks_prepared=ks_prepared, ks=None, form="compact",
                           bk_compact=bk_rows)
        u = bootstrap_woKS(gates.MU_BOOL, temp, ek_local, params, rotation_impl)
        out = _keyswitch_tp(u, ks_prepared.to(dev), _f32(ks_var, dev), params.ks.t,
                            params.ks.basebit, n_in, mesh)
        return _dp_outputs(out, mesh)

    return gate_fn


def make_sharded_nand(mesh: Mesh, params: GateBootstrappingParams,
                      rotation_impl: str = "auto"):
    """NAND = bootstrap((0, 1/8) - ca - cb), sharded (:func:`make_sharded_gate`)."""
    return make_sharded_gate(mesh, params, gates._t32(1, 8), -1, -1, rotation_impl)


# ---------------------------------------------------------------------------
# TP external product: TGSW-row split of the blind rotation (key-partitioned
# mode): each rank holds the key rows of its gadget rows j.
# ---------------------------------------------------------------------------

def _rotated_digits(acc: torch.Tensor, bara_i: torch.Tensor, params) -> torch.Tensor:
    """decompose_h((X^bara_i - 1) * acc): the CMux step's gadget digits (B, J, N)."""
    rot = rotate.mul_by_xai(acc, bara_i[:, None])
    return decompose_h(wrap32(rot.to(torch.int64) - acc.to(torch.int64)), params.tgsw_params)


def shard_ntt_key_rows(key: torch.Tensor, mesh: Mesh) -> Sharded:
    """This rank's block of the "ntt_scan" key (n, P, F, K, 2M) int8 with its
    contraction axis K cut over tp.  K = (j, r1) is j-major
    (``ops/blind_rotate.py``), so rank r of tp keeps K rows
    [r K/tp, (r+1) K/tp): whole TGSW rows j, 1/tp of the bootstrapping key
    (the memory-bound "key-partitioned" mode)."""
    return shard(key, (None, None, None, ("tp",), None), mesh)


def blind_rotate_ntt_tp(acc0: torch.Tensor, bara: torch.Tensor, key: Sharded,
                        params: GateBootstrappingParams, ctx: ntt.NttContext, mesh: Mesh,
                        rotation_impl: str = "auto", axis: str = "tp") -> torch.Tensor:
    """Blind rotation with the external-product contraction split over tp.

    Per step, each rank decomposes the (tp-replicated, dp-sliced)
    accumulator, keeps its gadget rows' digits, runs the whole NTT pipeline
    against its key rows (a j-subset of the convolution stays inside the
    same CRT bound as the whole sum), and an exact sum mod 2^32 over tp
    merges the partial updates.  Bit-identical to the unsharded rotation.

    Args:
      acc0: (B, k+1, N) int32; bara: (n, B) int32; key: this rank's block
      from :func:`shard_ntt_key_rows`; ctx: the key's context.
    Returns the whole (B, k+1, N) int32 result on every rank.
    """
    check_rotation_impl(rotation_impl)
    J, ntp, tidx = params.tgsw_params.kpl, mesh.size(axis), mesh.index(axis)
    if J % ntp:
        raise ValueError(f"kpl={J} gadget rows do not split over {axis}={ntp}")
    J_local = J // ntp
    acc = batch_slice(acc0, mesh)
    bara_l = batch_slice(bara, mesh, dim=1)
    key_l = key.local
    for i in range(bara_l.shape[0]):
        digits = _rotated_digits(acc, bara_l[i], params)[:, tidx * J_local:(tidx + 1) * J_local]
        delta = ntt.external_product_ntt(digits, ntt.join_key_bytes(key_l[i]), ctx)
        delta = mesh.psum(delta, axis)                                # exact mod 2^32
        acc = wrap32(acc.to(torch.int64) + delta.to(torch.int64))
    return mesh.all_gather(acc, "dp", 0)


# ---------------------------------------------------------------------------
# Frequency-split TP external product with all_to_all (the small-batch
# latency path): each rank owns an F-slice of the NTT spectrum, so the
# forward NTT and the pointwise product are local to the slice, one
# all_to_all repartitions the spectrum from frequency-cut to output-column-
# cut, the inverse NTT is local, and one all_gather rebuilds the update.
# ---------------------------------------------------------------------------

def _extprod_freq_step(digits: torch.Tensor, key_l: torch.Tensor, ctx: ntt.NttContext,
                       f0: int) -> torch.Tensor:
    """Local forward NTT + pointwise product for this rank's frequency slice.

    digits: (B, J, N) int32 (equal over tp); key_l: (P, F_loc, K, M) int16,
    this rank's F-slice [f0, f0 + F_loc) of one key step.
    Returns chat (P, F_loc, B, M) int64, balanced per prime.
    """
    B, J, _ = digits.shape
    F_loc, K = key_l.shape[1], key_l.shape[2]
    sub = ntt.to_subpolys(digits, ctx.R)                              # (B, J, R, F)
    chats = []
    for pi, p in enumerate(ctx.primes):
        dhat = ntt.mod_matmul(sub, ctx.W[pi][:, f0:f0 + F_loc], p)    # (B, J, R, F_loc)
        dhat = dhat.reshape(B, K, F_loc).permute(2, 0, 1)             # (F_loc, B, K)
        chats.append(ntt.mod_matmul(dhat, key_l[pi], p))              # (F_loc, B, M)
    return torch.stack(chats)


def _freq_local_rotate(acc0_l: torch.Tensor, bara_l: torch.Tensor, key_l: torch.Tensor,
                       ctx: ntt.NttContext, params: GateBootstrappingParams, mesh: Mesh,
                       axis: str = "tp") -> torch.Tensor:
    """One rank's frequency-split blind rotation of its dp slice (the body
    of :func:`blind_rotate_ntt_freq_tp` and :func:`make_sharded_gate_freq`).

    key_l: (n, P, F_loc, K, 2M) int8, this rank's F-slice of the key.
    """
    ntp, tidx = mesh.size(axis), mesh.index(axis)
    R, F, L = ctx.R, ctx.F, ctx.key_limbs
    if F % ntp:
        raise ValueError(f"F={F} frequencies do not split over {axis}={ntp}")
    B, U, N = acc0_l.shape
    UR = U * R
    if UR % ntp:
        raise ValueError(f"U*R={UR} output columns do not split over {axis}={ntp}")
    F_loc = F // ntp
    acc = acc0_l
    for i in range(bara_l.shape[0]):
        digits = _rotated_digits(acc, bara_l[i], params)
        chat = _extprod_freq_step(digits, ntt.join_key_bytes(key_l[i]), ctx, tidx * F_loc)
        # all_to_all: frequency-cut -> output-column-cut; columns are (l, u, s)
        chat = chat.reshape(len(ctx.primes), F_loc, B, L, UR)
        chat = mesh.all_to_all(chat, axis, split_dim=4, concat_dim=1)  # (P, F, B, L, UR_loc)
        res = [ntt.ntt_inverse_prime(chat[pi].permute(1, 2, 3, 0), ctx, pi)
               for pi in range(len(ctx.primes))]                       # (B, L, UR_loc, F)
        out_l = ntt.limb_sum(ntt.crt(res, ctx), ctx, dim=1)
        upd = mesh.all_gather(out_l, axis, 1)                         # (B, UR, F)
        upd = ntt.from_subpolys(upd.reshape(B, U, R, F))
        acc = wrap32(acc.to(torch.int64) + upd.to(torch.int64))
    return acc


def shard_ntt_key_freq(key: torch.Tensor, mesh: Mesh) -> Sharded:
    """This rank's block of the "ntt_scan" key (n, P, F, K, 2M) int8 with the
    NTT frequency axis cut over tp (each rank stores 1/tp of the key: the
    all_to_all latency mode)."""
    return shard(key, (None, None, ("tp",), None, None), mesh)


def blind_rotate_ntt_freq_tp(acc0: torch.Tensor, bara: torch.Tensor, key: Sharded,
                             params: GateBootstrappingParams, ctx: ntt.NttContext,
                             mesh: Mesh, rotation_impl: str = "auto",
                             axis: str = "tp") -> torch.Tensor:
    """Blind rotation with the external product split over the NTT frequency
    axis (all_to_all mode), bit-identical to the unsharded rotation.

    Args:
      acc0: (B, k+1, N) int32; bara: (n, B) int32; key: this rank's block
      from :func:`shard_ntt_key_freq`.
    Returns the whole (B, k+1, N) int32 result on every rank.
    """
    check_rotation_impl(rotation_impl)
    acc = _freq_local_rotate(batch_slice(acc0, mesh), batch_slice(bara, mesh, dim=1),
                             key.local, ctx, params, mesh, axis)
    return mesh.all_gather(acc, "dp", 0)


def make_sharded_gate_freq(mesh: Mesh, params: GateBootstrappingParams,
                           offset_t32: int, sa: int, sb: int, ctx: ntt.NttContext,
                           rotation_impl: str = "auto"):
    """Gate-level frequency-split path: a two-input bootstrapped gate whose
    blind rotation runs the all_to_all frequency split (the small-batch
    latency mode: each rank holds 1/tp of the key and 1/tp of the spectrum
    work).

    Returns fn(ca_a, ca_b, ca_var, cb_a, cb_b, cb_var, key_freq, bk_var,
    ks_prepared, ks_var) -> (a, b, var): the batch sharded over dp, the
    spectrum over tp (``key_freq`` from :func:`shard_ntt_key_freq`), the
    keyswitch rows over tp (:func:`_keyswitch_tp`); outputs and variance
    rail bit-identical to the unsharded gate.
    """
    n_in = params.N * params.k
    gates.check_noise_budget(params, sa, sb)
    check_rotation_impl(rotation_impl)
    tl = params.tgsw_params.tlwe_params

    def gate_fn(ca_a, ca_b, ca_var, cb_a, cb_b, cb_var, key_freq, bk_var,
                ks_prepared, ks_var):
        temp = _dp_inputs(mesh, offset_t32, sa, sb, ca_a, ca_b, ca_var, cb_a, cb_b, cb_var)
        acc0, bara = blind_rotate_inputs(gates.MU_BOOL, temp, params)
        acc = _freq_local_rotate(acc0, bara, key_freq.local, ctx, params, mesh)
        zeros = torch.zeros(temp.b.shape, dtype=torch.float32, device=acc.device)
        u = tlwe_extract_lwe_sample(TLweCiphertext(a=acc.reshape(temp.b.shape + (tl.k + 1, tl.N)),
                                                   current_variance=zeros))
        var = blind_rotate_output_variance(params, _f32(bk_var, acc.device))
        u = LweCiphertext(a=u.a, b=u.b, current_variance=var.expand(temp.b.shape))
        out = _keyswitch_tp(u, ks_prepared.to(acc.device), _f32(ks_var, acc.device),
                            params.ks.t, params.ks.basebit, n_in, mesh)
        return _dp_outputs(out, mesh)

    return gate_fn


def make_sharded_nand_freq(mesh: Mesh, params: GateBootstrappingParams,
                           ctx: ntt.NttContext, rotation_impl: str = "auto"):
    """Frequency-split NAND (small-batch latency mode, gate level)."""
    return make_sharded_gate_freq(mesh, params, gates._t32(1, 8), -1, -1, ctx, rotation_impl)
