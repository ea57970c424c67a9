"""Llama-family inference: the AO-Llama / llama.cpp equivalent, in PyTorch.

Port of ``eoc_tfhe_tpu/models/llama.py``.  Upstream ships llama.cpp inside
the same wasm module as the TFHE core, driven through the AO-Llama Lua
bindings, with weights in the llama2.c ``.bin`` format (SURVEY.md §2.3).

The design is the reference's, so weights and caches carry across unchanged:

  * weights are a **layer-stacked** dict: every per-layer tensor carries a
    leading L axis, and matrices are (in, out) for right-multiplication;
  * the KV cache is one static ``(L, 2, B, S, Hkv, hd)`` tensor; decode
    attends over the whole window ``S`` with a ``-1e30`` fill, so masked
    positions give exact zeros;
  * RoPE follows the llama2.c convention (adjacent even/odd pairs), its
    tables built in float64 numpy and rounded to float32.

The numerics are the reference's XLA ones, made explicit (:func:`matmul`,
:func:`_einsum_f32`): a bf16 activation times a float32 weight is a float32
product of the bf16 values; bf16 times bf16 (the classifier) is a bf16
result of a float32 accumulation; the attention einsums take bf16 operands
to a float32 result.  On the card each product runs inside its own
:func:`~eoc_tfhe_tpu_torch.device.exact_matmuls` scope, so float32 products
are full float32 (no TF32) and bf16 products reduce in float32, and another
thread's products (a gate server's keyswitch) wait for one product, not for
a whole pass.

The reference's function names are kept as plain functions on tensors
(``init_params``, ``rope_tables``, ``forward``, ``prefill``,
``init_kv_cache``, ``decode_step``, ``generate``, ...); :class:`Llama` is
the ``nn.Module`` that holds the stacked tensors and calls them.

Tensor parallelism is an annotation in the reference (:func:`llama_param_specs`,
which GSPMD turns into code); here it is code.  :func:`shard_params` keeps
this rank's slices (QKV, w1 and w3 cut by columns, QKV by whole heads; wo
and w2 by rows), and ``forward`` / ``prefill`` / ``decode_step`` given a tp
process group run the local heads and sum the wo and w2 products over the
group: one all-reduce after each, two a layer.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..device import exact_matmuls, resolve_device
from ..parallel.mesh import psum

#: The stacked per-layer tensors, in the reference's order.
LAYER_KEYS = ("attention_norm", "wq", "wk", "wv", "wo", "ffn_norm", "w1", "w2", "w3")

#: Score of a masked attention position (the reference's fill).
_MASKED = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    max_seq_len: int
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    shared_classifier: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def init_params(generator: torch.Generator, cfg: LlamaConfig,
                dtype=torch.float32, device=None) -> dict:
    """Random small-init parameters (layer-stacked) on ``device`` (the card
    unless named): normal(0, 0.02) matrices and embeddings, unit norms.
    ``generator`` must live on that device."""
    D, H, L = cfg.dim, cfg.hidden_dim, cfg.n_layers
    KD = cfg.n_kv_heads * cfg.head_dim
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params on {dev}")

    def w(*shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
                * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    params = {"tok_embeddings": w(cfg.vocab_size, D), "attention_norm": ones(L, D),
              "wq": w(L, D, D), "wk": w(L, D, KD), "wv": w(L, D, KD), "wo": w(L, D, D),
              "ffn_norm": ones(L, D), "w1": w(L, D, H), "w2": w(L, H, D),
              "w3": w(L, D, H), "norm": ones(D)}
    if not cfg.shared_classifier:
        params["output"] = w(cfg.vocab_size, D)
    return params


def params_from_numpy(params: dict, device=None, dtype=None) -> dict:
    """The reference's params (a dict of numpy arrays, as
    ``checkpoint.load_llama2c`` or ``np.asarray`` of the JAX ``init_params``
    give them) as tensors on ``device`` (the card unless named), in their own
    dtype or ``dtype``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.require(v, requirements="CW")).to(dev, dtype)
            for k, v in params.items()}


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under JAX's type promotion (``jnp.promote_types``), which
    ``torch.matmul`` does not do for mixed dtypes: bf16 x float32 is a
    float32 product of the bf16 values; bf16 x bf16 stays bf16."""
    dt = torch.promote_types(a.dtype, b.dtype)
    with exact_matmuls():
        return torch.matmul(a.to(dt), b.to(dt))


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=float32)``: the operands'
    values (bf16 widens to float32 exactly) multiplied and summed in float32."""
    with exact_matmuls():
        return torch.einsum(eq, a.float(), b.float())


def llama_param_specs(cfg: LlamaConfig) -> dict:
    """Per-dimension specs for tensor parallelism over a mesh "tp" axis (the
    reference's PartitionSpecs as tuples).

    Megatron-style: QKV/w1/w3 column-sharded, wo/w2 row-sharded, so each
    layer needs exactly one all-reduce per block.
    """
    col, row = (None, None, "tp"), (None, "tp", None)
    return {"tok_embeddings": (None, None), "attention_norm": (None, None),
            "wq": col, "wk": col, "wv": col, "wo": row, "ffn_norm": (None, None),
            "w1": col, "w2": row, "w3": col, "norm": (None,), "output": (None, None)}


def _tp_size(cfg: LlamaConfig, tp: int) -> int:
    """``tp``, checked against whole heads: both head counts divide by it."""
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide n_heads={cfg.n_heads} and "
                         f"n_kv_heads={cfg.n_kv_heads}")
    return tp


def shard_params(params: dict, specs: dict, mesh) -> dict:
    """This rank's tp slices of the layer-stacked params (``specs`` from
    :func:`llama_param_specs`): a dimension marked "tp" keeps block
    ``mesh.index("tp")`` of ``mesh.tp``; the others stay whole.  The QKV
    columns and the wo rows are (head, hd) major, so the blocks are whole
    heads when the head counts divide by tp (checked by ``forward``)."""
    tp, idx = mesh.size("tp"), mesh.index("tp")
    out = {}
    for name, x in params.items():
        for d, axis in enumerate(specs[name]):
            if axis == "tp":
                if x.shape[d] % tp:
                    raise ValueError(f"{name} dimension {d} ({x.shape[d]}) does not "
                                     f"split over tp={tp}")
                blk = x.shape[d] // tp
                x = x.narrow(d, idx * blk, blk).contiguous()
        out[name] = x
    return out


def _tp_sum(x: torch.Tensor, tp_group) -> torch.Tensor:
    """The sum over the tp group of each rank's partial product."""
    return x if tp_group is None else psum(x, tp_group)


def _group_size(tp_group) -> int:
    return 1 if tp_group is None else dist.get_world_size(tp_group)


def _rmsnorm(x, g, eps):
    x = x.float()
    return (x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)) * g


def rope_tables_np(cfg: LlamaConfig) -> tuple[np.ndarray, np.ndarray]:
    """(max_seq_len, head_dim/2) float64 cos/sin tables, llama2.c pair
    convention (the reference's arithmetic, in numpy)."""
    hd = cfg.head_dim
    freqs = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2)[: hd // 2] / hd))
    ang = np.outer(np.arange(cfg.max_seq_len), freqs)
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=16)
def rope_tables(cfg: LlamaConfig, device, dtype=torch.float32):
    """(max_seq_len, head_dim/2) cos/sin tables, built in float64 and rounded
    to ``dtype`` (a float32 ``torch.pow`` would give other bits).  Cached per
    (config, dtype, device): the tensors are shared, never write to them."""
    cos, sin = rope_tables_np(cfg)
    return (torch.from_numpy(cos).to(device, dtype), torch.from_numpy(sin).to(device, dtype))


def _apply_rope(x, cos, sin):
    """x: (B, T, H, hd); cos/sin: (T, hd/2). Adjacent-pair rotation."""
    xr = x.float().reshape(*x.shape[:-1], -1, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(x.shape)


def _attn(q, k, v, mask):
    """q: (B,T,Hq,hd), k/v: (B,S,Hkv,hd) -> (B,T,Hq,hd). GQA by head repeat."""
    hd = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = _einsum_f32("bthd,bshd->bhts", q, k) / np.float32(np.sqrt(hd))
    scores = torch.where(mask, scores, _MASKED)
    probs = torch.softmax(scores, dim=-1)
    out = _einsum_f32("bhts,bshd->bthd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def _block(x, lp, cfg: LlamaConfig, cos, sin, kv_cache, pos, mask, compute_dtype,
           tp_group=None):
    """One decoder layer. kv_cache: None or (k, v) each (B, S, Hkv, hd),
    written at ``pos`` in place.  With a tp group, ``lp`` holds this rank's
    slices (:func:`shard_params`): its heads, and the wo and w2 products'
    partial sums are summed over the group."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    tp = _tp_size(cfg, _group_size(tp_group))
    Hq, Hkv = cfg.n_heads // tp, cfg.n_kv_heads // tp

    h = _rmsnorm(x, lp["attention_norm"], cfg.norm_eps).to(compute_dtype)
    q = matmul(h, lp["wq"]).reshape(B, T, Hq, hd)
    k = matmul(h, lp["wk"]).reshape(B, T, Hkv, hd)
    v = matmul(h, lp["wv"]).reshape(B, T, Hkv, hd)
    q = _apply_rope(q, cos, sin).to(compute_dtype)
    k = _apply_rope(k, cos, sin).to(compute_dtype)

    if kv_cache is not None:
        ck, cv = kv_cache
        ck[:, pos:pos + T] = k.to(ck.dtype)
        cv[:, pos:pos + T] = v.to(cv.dtype)
        att = _attn(q, ck.to(compute_dtype), cv.to(compute_dtype), mask)
        new_cache = (ck, cv)
    else:
        att = _attn(q, k, v, mask)
        new_cache = (k, v)      # this call's keys/values (prefill collects)
    x = x + _tp_sum(matmul(att.reshape(B, T, Hq * hd), lp["wo"]).float(), tp_group)

    h = _rmsnorm(x, lp["ffn_norm"], cfg.norm_eps).to(compute_dtype)
    gate = torch.nn.functional.silu(matmul(h, lp["w1"]).float()).to(compute_dtype)
    x = x + _tp_sum(matmul(gate * matmul(h, lp["w3"]), lp["w2"]).float(), tp_group)
    return x, new_cache


def _layer(params: dict, li: int) -> dict:
    return {k: params[k][li] for k in LAYER_KEYS}


def _classify(x, params: dict, compute_dtype):
    """Final classifier: (x in bf16) @ (the weight in bf16).T -> float32."""
    out_w = params.get("output", params["tok_embeddings"])
    return matmul(x.to(compute_dtype), out_w.to(compute_dtype).T).float()


def _causal(T: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))[None, None]


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            compute_dtype=torch.bfloat16, tp_group=None) -> torch.Tensor:
    """Full-sequence causal forward: (B, T) int -> (B, T, V) float32 logits.
    With ``tp_group``, ``params`` are this rank's :func:`shard_params` and
    every rank of the group gets the whole logits."""
    T = tokens.shape[1]
    emb = params["tok_embeddings"]
    cos, sin = rope_tables(cfg, device=emb.device)
    mask = _causal(T, emb.device)
    x = emb[tokens].float()
    for li in range(cfg.n_layers):
        x, _ = _block(x, _layer(params, li), cfg, cos[:T], sin[:T], None, 0, mask,
                      compute_dtype, tp_group)
    x = _rmsnorm(x, params["norm"], cfg.norm_eps)
    return _classify(x, params, compute_dtype)


def prefill(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            compute_dtype=torch.bfloat16, tp_group=None):
    """One full-sequence pass that POPULATES the KV cache: (B, Tp) int ->
    (last-position logits (B, V) float32, cache (L, 2, B, S, Hkv, hd)).
    With ``tp_group`` the cache holds this rank's Hkv / tp heads.

    Prompt ingestion as one batched causal forward instead of Tp sequential
    :func:`decode_step` calls.  The returned cache is ``init_kv_cache``-shaped
    (in ``compute_dtype``, zero past Tp), so ``decode_step`` continues from
    position Tp.
    """
    B, T = tokens.shape
    if T > cfg.max_seq_len:
        raise ValueError(f"{T} prompt tokens exceed max_seq_len {cfg.max_seq_len}")
    emb = params["tok_embeddings"]
    cos, sin = rope_tables(cfg, device=emb.device)
    mask = _causal(T, emb.device)
    tp = _tp_size(cfg, _group_size(tp_group))
    cache = init_kv_cache(dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // tp), B,
                          compute_dtype, device=emb.device)
    x = emb[tokens].float()
    for li in range(cfg.n_layers):
        x, (k, v) = _block(x, _layer(params, li), cfg, cos[:T], sin[:T], None, 0, mask,
                           compute_dtype, tp_group)
        cache[li, 0, :, :T] = k.to(compute_dtype)
        cache[li, 1, :, :T] = v.to(compute_dtype)
    x = _rmsnorm(x[:, -1], params["norm"], cfg.norm_eps)
    return _classify(x, params, compute_dtype), cache


def init_kv_cache(cfg: LlamaConfig, batch: int, dtype=torch.bfloat16, device=None):
    """(L, 2, B, S, Hkv, hd) stacked zero cache on ``device`` (the card
    unless named)."""
    shape = (cfg.n_layers, 2, batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


def decode_step(params: dict, cache: torch.Tensor, pos: int, tokens: torch.Tensor,
                cfg: LlamaConfig, compute_dtype=torch.bfloat16, tp_group=None):
    """One token for the whole batch. tokens: (B,) int; pos: int.

    Writes the token's keys and values into ``cache`` at ``pos`` (in place)
    and returns (logits (B, V) float32, cache).  With ``tp_group``, ``params``
    and ``cache`` are this rank's (:func:`shard_params`, ``prefill``).
    """
    pos = int(pos)
    emb = params["tok_embeddings"]
    cos, sin = rope_tables(cfg, device=emb.device)
    # Causal over the static window: key position s visible iff s <= pos.
    mask = (torch.arange(cfg.max_seq_len, device=emb.device) <= pos)[None, None, None, :]
    x = emb[tokens][:, None, :].float()
    for li in range(cfg.n_layers):
        x, _ = _block(x, _layer(params, li), cfg, cos[pos:pos + 1], sin[pos:pos + 1],
                      (cache[li, 0], cache[li, 1]), pos, mask, compute_dtype, tp_group)
    x = _rmsnorm(x[:, 0], params["norm"], cfg.norm_eps)
    return _classify(x, params, compute_dtype), cache


def generate(params: dict, prompt: torch.Tensor, n_new: int, cfg: LlamaConfig,
             temperature: float = 0.0, generator: torch.Generator | None = None,
             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Greedy (``temperature == 0``) or temperature-sampled generation.

    prompt: (B, Tp) int. Returns (B, n_new) int32.  The prompt is ingested
    one :func:`decode_step` at a time, as in the reference.  Sampling draws
    from softmax(logits / temperature) with ``generator`` (it must be on the
    params' device); JAX's PRNG stream is not reproduced, so sampled ids
    match the reference by distribution only.  Greedy ids match exactly.
    """
    B, Tp = prompt.shape
    if Tp + n_new > cfg.max_seq_len:
        raise ValueError(f"{Tp} + {n_new} tokens exceed max_seq_len {cfg.max_seq_len}")
    if temperature != 0.0 and generator is None:
        raise ValueError("temperature sampling needs an explicit torch.Generator")
    dev = params["tok_embeddings"].device
    prompt = prompt.to(dev)
    cache = init_kv_cache(cfg, B, compute_dtype, device=dev)
    logits = None
    for t in range(Tp):
        logits, cache = decode_step(params, cache, t, prompt[:, t], cfg, compute_dtype)

    toks = []
    for i in range(n_new):
        if temperature == 0.0:
            tok = torch.argmax(logits, -1)
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        toks.append(tok.to(torch.int32))
        if i + 1 < n_new:       # the last token's logits are never read
            logits, cache = decode_step(params, cache, Tp + i, tok, cfg, compute_dtype)
    return torch.stack(toks, dim=1) if toks else torch.zeros((B, 0), dtype=torch.int32,
                                                             device=dev)


class Llama(nn.Module):
    """The layer-stacked weights as buffers, with the functions above as
    methods.  ``Llama(params, cfg).to(device)`` moves every tensor."""

    def __init__(self, params: dict, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        for name, value in params.items():
            self.register_buffer(name, value)

    @property
    def params(self) -> dict:
        return dict(self.named_buffers())

    def forward(self, tokens, compute_dtype=torch.bfloat16):
        return forward(self.params, tokens, self.cfg, compute_dtype)

    def prefill(self, tokens, compute_dtype=torch.bfloat16):
        return prefill(self.params, tokens, self.cfg, compute_dtype)

    def decode_step(self, cache, pos, tokens, compute_dtype=torch.bfloat16):
        return decode_step(self.params, cache, pos, tokens, self.cfg, compute_dtype)

    def generate(self, prompt, n_new, temperature=0.0, generator=None,
                 compute_dtype=torch.bfloat16):
        return generate(self.params, prompt, n_new, self.cfg, temperature, generator,
                        compute_dtype)
