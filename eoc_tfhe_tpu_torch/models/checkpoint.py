"""llama2.c ``.bin`` checkpoint codec (upstream's model format).

A copy of ``eoc_tfhe_tpu/models/checkpoint.py`` (numpy); :func:`save_llama2c`
also takes the port's tensors, on any device.  Upstream converts Llama
weights to llama2.c-style ``.bin`` files for its in-wasm inference engine
(``scripts/convert-model.py``: ``legacy_export`` v0, ``version1_export``
fp32 v1, Q8_0 int8 v2) and uploads them chunked to Arweave
(``scripts/publish-model``).  This module reads and writes the same
formats, byte for byte as the JAX package does, so checkpoints flow both
ways.

Layouts (little-endian):
  v0 (legacy): header ``iiiiiii`` = (dim, hidden_dim, n_layers, n_heads,
    n_kv_heads, vocab_size, max_seq_len) — vocab_size is NEGATED when the
    classifier is untied — then fp32 tensors: tok_embeddings,
    {attention_norm, wq, wk, wv, wo, ffn_norm, w1, w2, w3} each grouped by
    tensor across layers, final norm, freqs_cos, freqs_sin, [output].
  v1: 256-byte header [magic 0x616b3432 ("ak42"), version=1, the 7 ints,
    shared_classifier byte, zero pad], then norms first, then matmul
    weights, then [output]. No freqs tables (recomputed).
  v2 (Q8_0): 256-byte header [magic, version=2, the 7 ints,
    shared_classifier byte, group_size int32, zero pad], then fp32 norms
    (attention norms, ffn norms, final norm), then each quantized tensor as
    int8 values followed by per-group fp32 scales, in order:
    tok_embeddings, wq*L, wk*L, wv*L, wo*L, w1*L, w2*L, w3*L, [output]
    (upstream ``convert-model.py`` ``version2_export``).

Weight orientation: the files store torch ``nn.Linear`` weights (out, in);
this framework right-multiplies, so matrices are transposed to (in, out)
on load and back on save.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .llama import LlamaConfig, rope_tables_np

_MAGIC = 0x616B3432


def _layer_keys():
    return ("attention_norm", "wq", "wk", "wv", "wo", "ffn_norm",
            "w1", "w2", "w3")


def _mats():
    return {"wq", "wk", "wv", "wo", "w1", "w2", "w3"}


#: v2 quantized-tensor order (tensor-type grouped across layers).
_V2_MATS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def save_llama2c(path: str, params: dict, cfg: LlamaConfig,
                 version: int = 0, group_size: int = 64) -> None:
    """Write a v0 (legacy), v1 (fp32) or v2 (Q8_0 int8) llama2.c checkpoint."""
    p = {k: _host_f32(v) for k, v in params.items()}
    shared = "output" not in p
    hdr7 = struct.pack(
        "<iiiiiii", cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.n_heads,
        cfg.n_kv_heads, cfg.vocab_size if (shared or version != 0)
        else -cfg.vocab_size, cfg.max_seq_len)

    def mat(name, li):
        w = p[name][li]
        return w.T if name in _mats() else w      # back to torch (out, in)

    with open(path, "wb") as f:
        if version == 0:
            f.write(hdr7)
            f.write(p["tok_embeddings"].tobytes())
            for name in _layer_keys():
                for li in range(cfg.n_layers):
                    f.write(np.ascontiguousarray(mat(name, li)).tobytes())
            f.write(p["norm"].tobytes())
            cos, sin = rope_tables_np(cfg)
            f.write(cos.astype(np.float32).tobytes())
            f.write(sin.astype(np.float32).tobytes())
            if not shared:
                f.write(p["output"].tobytes())
        elif version == 1:
            f.write(struct.pack("<Ii", _MAGIC, 1))
            f.write(hdr7)
            f.write(struct.pack("B", int(shared)))
            f.write(b"\0" * (256 - 4 - 4 - 28 - 1))
            for name in ("attention_norm", "ffn_norm"):
                for li in range(cfg.n_layers):
                    f.write(np.ascontiguousarray(mat(name, li)).tobytes())
            f.write(p["norm"].tobytes())
            f.write(p["tok_embeddings"].tobytes())
            for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
                for li in range(cfg.n_layers):
                    f.write(np.ascontiguousarray(mat(name, li)).tobytes())
            if not shared:
                f.write(p["output"].tobytes())
        elif version == 2:
            while cfg.dim % group_size != 0:   # reference BACKOFF behavior
                group_size //= 2
            f.write(struct.pack("<Ii", _MAGIC, 2))
            f.write(hdr7)
            f.write(struct.pack("B", int(shared)))
            f.write(struct.pack("<i", group_size))
            f.write(b"\0" * (256 - 4 - 4 - 28 - 1 - 4))
            for name in ("attention_norm", "ffn_norm"):
                for li in range(cfg.n_layers):
                    f.write(np.ascontiguousarray(mat(name, li)).tobytes())
            f.write(p["norm"].tobytes())
            quantized = [p["tok_embeddings"]]
            for name in _V2_MATS:
                quantized += [np.ascontiguousarray(mat(name, li))
                              for li in range(cfg.n_layers)]
            if not shared:
                quantized.append(p["output"])
            for w in quantized:
                q, scale, _err = quantize_q80(w, group_size)
                f.write(q.tobytes())
                f.write(scale.astype("<f4").tobytes())
        else:
            raise ValueError(f"unsupported export version {version}")


def _host_f32(v) -> np.ndarray:
    """A weight (numpy array or tensor on any device) as host float32."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def _read_f32(f, shape) -> np.ndarray:
    count = int(np.prod(shape))
    return np.frombuffer(f.read(4 * count), "<f4").reshape(shape).copy()


def load_llama2c(path, max_seq_len: int | None = None
                 ) -> tuple[LlamaConfig, dict]:
    """Read a v0/v1/v2 llama2.c checkpoint -> (config, layer-stacked params).

    ``path`` may be a filesystem path or a binary file-like object (e.g. a
    BytesIO over bytes fetched through the WeaveDrive-analog virtual FS /
    publish chain: the AO-Llama load path, models/ao_llama.py).  The
    params are host numpy float32; :func:`.llama.params_from_numpy` carries
    them to a device.
    """
    if hasattr(path, "read"):
        import contextlib
        opener = contextlib.nullcontext(path)
    else:
        opener = open(path, "rb")
    with opener as f:
        first = struct.unpack("<I", f.read(4))[0]
        group_size = 0
        if first == _MAGIC:
            version = struct.unpack("<i", f.read(4))[0]
            if version not in (1, 2):
                raise ValueError(f"unsupported .bin version {version}")
            dim, hid, L, nh, nkv, vocab, msl = struct.unpack("<iiiiiii",
                                                             f.read(28))
            shared = bool(f.read(1)[0])
            if version == 2:
                (group_size,) = struct.unpack("<i", f.read(4))
                f.read(256 - 4 - 4 - 28 - 1 - 4)
            else:
                f.read(256 - 4 - 4 - 28 - 1)
        else:
            version = 0
            rest = struct.unpack("<iiiiii", f.read(24))
            dim, hid, L, nh, nkv, vocab, msl = (first,) + rest
            dim = np.int32(dim).item()
            shared = vocab > 0
            vocab = abs(vocab)

        cfg = LlamaConfig(dim=dim, hidden_dim=hid, n_layers=L, n_heads=nh,
                          n_kv_heads=nkv, vocab_size=vocab,
                          max_seq_len=max_seq_len or msl,
                          shared_classifier=shared)
        hd = cfg.head_dim
        kd = nkv * hd
        shapes = {"attention_norm": (dim,), "wq": (dim, dim), "wk": (kd, dim),
                  "wv": (kd, dim), "wo": (dim, dim), "ffn_norm": (dim,),
                  "w1": (hid, dim), "w2": (dim, hid), "w3": (hid, dim)}

        def rd_layers(name):
            ws = [_read_f32(f, shapes[name]) for _ in range(L)]
            ws = [w.T if name in _mats() else w for w in ws]
            return np.stack(ws)

        params: dict = {}
        if version == 0:
            params["tok_embeddings"] = _read_f32(f, (vocab, dim))
            for name in _layer_keys():
                params[name] = rd_layers(name)
            params["norm"] = _read_f32(f, (dim,))
            _read_f32(f, (msl, hd // 2))    # freqs_cos (recomputed)
            _read_f32(f, (msl, hd // 2))    # freqs_sin
            if not shared:
                params["output"] = _read_f32(f, (vocab, dim))
        elif version == 1:
            for name in ("attention_norm", "ffn_norm"):
                params[name] = rd_layers(name)
            params["norm"] = _read_f32(f, (dim,))
            params["tok_embeddings"] = _read_f32(f, (vocab, dim))
            for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
                params[name] = rd_layers(name)
            if not shared:
                params["output"] = _read_f32(f, (vocab, dim))
        else:  # v2 Q8_0
            def rd_q80(shape):
                count = int(np.prod(shape))
                q = np.frombuffer(f.read(count), np.int8)
                s = np.frombuffer(f.read(4 * (count // group_size)), "<f4")
                w = (q.astype(np.float32).reshape(-1, group_size)
                     * s[:, None]).reshape(shape)
                return w

            for name in ("attention_norm", "ffn_norm"):
                params[name] = rd_layers(name)
            params["norm"] = _read_f32(f, (dim,))
            params["tok_embeddings"] = rd_q80((vocab, dim))
            for name in _V2_MATS:
                ws = [rd_q80(shapes[name]).T for _ in range(L)]
                params[name] = np.stack(ws)
            if not shared:
                params["output"] = rd_q80((vocab, dim))
    return cfg, params


def quantize_q80(w: np.ndarray, group_size: int):
    """Symmetric int8 quantization, llama2.c Q8_0 (upstream convert-model.py).

    Returns (int8 values, per-group f32 scales, max abs error).
    """
    assert w.size % group_size == 0
    flat = np.asarray(w, np.float32).reshape(-1, group_size)
    wmax = np.abs(flat).max(axis=1)
    scale = wmax / 127.0
    scale_safe = np.where(scale == 0, 1.0, scale)
    q = np.round(flat / scale_safe[:, None]).astype(np.int8)
    deq = q.astype(np.float32) * scale[:, None]
    maxerr = float(np.abs(deq - flat).max())
    return q, scale.astype(np.float32), maxerr
