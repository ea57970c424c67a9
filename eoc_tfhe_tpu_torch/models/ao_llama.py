"""AO-Llama backend: the ``require("llama")`` surface behind the Lua shim.

Port of ``eoc_tfhe_tpu/models/ao_llama.py`` onto the port's torch decoder.
Upstream co-hosts llama.cpp with the TFHE core in one wasm process and
drives it through the AO-Llama Lua module (``Llama.backend =
require("llama")``; SURVEY.md §3.1 boot stack).  The Lua shim embedded in
the shipped ``process.wasm`` exposes exactly::

    Llama.info() / .load(id) / .setPrompt(p) / .add(s) / .run(n) / .next()
    / .stop()  (+ onLog/onProgress callback plumbing)

forwarding 1:1 to backend functions ``load / set_prompt / add / run / next
/ stop``.  This module is the backend those names bind to
(:mod:`eoc_tfhe_tpu_torch.process` builds the Lua-facing tables): inference
runs the torch Llama decoder (:mod:`.llama`: one batched ``prefill`` for a
fresh prompt, then one ``decode_step`` a token through the static KV cache)
on the card unless ``device`` names another device.  Model bytes arrive
through the same two channels upstream uses:

  * a **publish chain** (:mod:`.publish`: the ``Next``-linked chunk list of
    ``scripts/publish-model``), which also carries the tokenizer; or
  * the **WeaveDrive-analog virtual FS** (:mod:`..io.virtualfs`) for flat
    ``.bin`` items, with the tokenizer at ``<id>.tokenizer``.

Generation is greedy (temperature 0): AO processes must be deterministic
under message replay (SURVEY.md §5), and greedy decode is the replay-safe
choice.
"""

from __future__ import annotations

import io as _io
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from . import checkpoint, llama, publish, tokenizer as tok_mod


class LlamaBackendError(Exception):
    pass


class LlamaBackend:
    """Stateful incremental generation session (one model, one stream).

    Mirrors the ao-llama C binding's process-global session: ``load``
    replaces the model, ``set_prompt`` resets the context, ``add`` appends,
    ``next``/``run`` decode.  The KV cache persists across calls so every
    token is prefilled exactly once.
    """

    def __init__(self, store=None, vfs=None,
                 on_log: Callable[[int, str], None] | None = None,
                 on_progress: Callable[[str], None] | None = None,
                 max_seq_len: int | None = None, device=None):
        #: Where the decoder runs: the card unless named.
        self.device = resolve_device(device)
        self.store = store
        self.vfs = vfs
        self.on_log = on_log or (lambda level, s: None)
        self.on_progress = on_progress or (lambda s: None)
        self.max_seq_len = max_seq_len
        self.cfg = None
        self.model = None           # llama.Llama on self.device
        self.tokenizer = None
        self._cache = None
        self._pos = 0               # tokens already in the KV cache
        self._pending: list[int] = []   # tokens not yet prefetched into cache
        self._last_logits = None    # logits after the last cached token
        self._utf8_buf = b""        # incomplete UTF-8 tail across tokens

    # -- model loading ------------------------------------------------------

    def _fetch(self, item_id: str) -> tuple[bytes, bytes]:
        """Resolve ``item_id`` to (model_bytes, tokenizer_bytes)."""
        if self.store is not None:
            try:
                tags = self.store.tags(item_id)
            except Exception:
                tags = None
            if tags is not None and tags.get("Type") == publish.TYPE_MODEL_CHUNK:
                self.on_log(4, f"loading publish chain {item_id}")
                return publish.fetch_model(self.store, item_id)
        if self.vfs is not None:
            self.on_log(4, f"loading {item_id} via virtual fs")
            model = self.vfs.read_all(item_id)
            tok = self.vfs.read_all(item_id + ".tokenizer")
            return model, tok
        raise LlamaBackendError(
            f"cannot resolve model id {item_id!r}: no store/vfs backend")

    def load(self, item_id: str) -> None:
        model_bytes, tok_bytes = self._fetch(item_id)
        cfg, params = checkpoint.load_llama2c(_io.BytesIO(model_bytes),
                                              max_seq_len=self.max_seq_len)
        self.cfg = cfg
        self.model = llama.Llama(llama.params_from_numpy(params, device=self.device), cfg)
        self.tokenizer = tok_mod.Tokenizer.loads(tok_bytes)
        if self.tokenizer.vocab_size != cfg.vocab_size:
            self.on_log(3, f"tokenizer vocab {self.tokenizer.vocab_size} != "
                           f"model vocab {cfg.vocab_size}")
        self.on_progress(".")
        self._reset_stream()
        self.on_log(4, f"model loaded: dim={cfg.dim} layers={cfg.n_layers} "
                       f"vocab={cfg.vocab_size}")

    # -- prompt management --------------------------------------------------

    def _require_model(self):
        if self.model is None:
            raise LlamaBackendError("no model loaded (call load first)")

    def _reset_stream(self) -> None:
        self._cache = llama.init_kv_cache(self.cfg, 1, device=self.device) \
            if self.model is not None else None
        self._pos = 0
        self._pending = []
        self._last_logits = None
        self._utf8_buf = b""

    def set_prompt(self, prompt: str) -> None:
        self._require_model()
        self._reset_stream()
        self._pending = list(self.tokenizer.encode(prompt, bos=False))

    def add(self, s: str) -> None:
        self._require_model()
        self._pending.extend(self.tokenizer.encode(s, bos=False))

    def stop(self) -> None:
        """Drop the generation stream (model stays loaded — matches the
        ao-llama binding, where stop ends the current run)."""
        self._reset_stream()

    # -- decoding -----------------------------------------------------------

    def _feed(self) -> None:
        """Ingest every pending token into the KV cache.

        A fresh multi-token prompt takes the batched single-pass
        :func:`llama.prefill` (the production prefill/decode split);
        mid-stream tokens take the single-token :func:`llama.decode_step`."""
        if self._pos + len(self._pending) > self.cfg.max_seq_len:
            raise LlamaBackendError(
                f"context window exhausted ({self.cfg.max_seq_len})")
        if self._pos == 0 and len(self._pending) > 1:
            toks = torch.tensor([self._pending], dtype=torch.int32, device=self.device)
            self._last_logits, self._cache = self.model.prefill(toks)
            self._pos = len(self._pending)
            self._pending = []
        while self._pending:
            tok = self._pending.pop(0)
            self._last_logits, self._cache = self.model.decode_step(
                self._cache, self._pos,
                torch.tensor([tok], dtype=torch.int32, device=self.device))
            self._pos += 1

    def _emit_piece(self, tok: int) -> str:
        """Token -> text with UTF-8 buffering across tokens: a multi-byte
        character split over byte-fallback tokens must not decode to
        replacement characters piecewise ('é' arrives as two byte
        tokens).  Incomplete trailing sequences wait in _utf8_buf for
        the next token; flushed by the next complete boundary."""
        buf = self._utf8_buf + self.tokenizer._bytes(tok)
        cut = len(buf)
        for i in range(1, min(4, len(buf)) + 1):
            c = buf[-i]
            if c < 0x80:          # ASCII tail — everything complete
                break
            if c >= 0xC0:         # lead byte: is its sequence complete?
                need = 2 if c < 0xE0 else 3 if c < 0xF0 else 4
                if i < need:
                    cut = len(buf) - i
                break
            # else continuation byte — keep scanning backwards
        out, self._utf8_buf = buf[:cut], buf[cut:]
        return out.decode("utf-8", errors="replace")

    def next(self) -> str:
        """Generate one token (greedy); returns its decoded piece."""
        self._require_model()
        if self._last_logits is None and not self._pending:
            raise LlamaBackendError("no prompt set (call set_prompt first)")
        self._feed()
        tok = int(torch.argmax(self._last_logits[0]))
        self._pending.append(tok)       # token joins the context
        self.on_progress(".")
        return self._emit_piece(tok)

    def run(self, count: int) -> str:
        """Generate ``count`` tokens; returns the concatenated text."""
        return "".join(self.next() for _ in range(int(count)))

    #: generated token ids so far are recoverable from the tokenizer pieces;
    #: expose the raw ids for hosts that want them (tests, batching tiers).
    def generated_ids(self, prompt: str, count: int) -> np.ndarray:
        """Convenience: batch-shaped greedy generation matching
        :func:`.llama.generate` exactly (used by parity tests)."""
        self.set_prompt(prompt)
        ids = []
        for _ in range(int(count)):
            self._feed()
            tok = int(torch.argmax(self._last_logits[0]))
            ids.append(tok)
            self._pending.append(tok)
        return np.asarray(ids, np.int32)
