"""llama2.c ``tokenizer.bin`` codec + BPE encode/decode.

A copy of ``eoc_tfhe_tpu/models/tokenizer.py`` (pure Python; the port keeps
its own copy because it imports nothing of the JAX package).  Upstream
exports SentencePiece vocabularies to a flat binary format for its in-wasm
engine (``scripts/generate-tokenizer.py``): ``uint32 max_token_length`` then,
per token id, ``f32 score, uint32 len, bytes``.  This module reads/writes
that format and implements the greedy score-BPE encoder the llama2.c runtime
uses, so prompts tokenize identically on both stacks.
"""

from __future__ import annotations

import struct

BOS_ID = 1
EOS_ID = 2
#: llama2.c raw-byte fallback tokens occupy ids 3..258 ("<0x00>".."<0xFF>").
BYTE_FALLBACK_OFFSET = 3


class Tokenizer:
    def __init__(self, tokens: list[bytes], scores: list[float]):
        assert len(tokens) == len(scores)
        self.tokens = tokens
        self.scores = scores
        self.lookup = {t: i for i, t in enumerate(tokens)}

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # -- binary format ------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        with open(path, "rb") as f:
            return cls.loads(f.read())

    @classmethod
    def loads(cls, data: bytes) -> "Tokenizer":
        """Parse tokenizer.bin bytes (e.g. fetched through the publish
        chain / virtual FS — the AO-Llama load path)."""
        import io as _io
        tokens, scores = [], []
        f = _io.BytesIO(data)
        (_max_len,) = struct.unpack("<I", f.read(4))
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            score, ln = struct.unpack("<fI", head)
            tokens.append(f.read(ln))
            scores.append(score)
        return cls(tokens, scores)

    def save(self, path: str) -> None:
        max_len = max((len(t) for t in self.tokens), default=0)
        with open(path, "wb") as f:
            f.write(struct.pack("<I", max_len))
            for t, s in zip(self.tokens, self.scores):
                f.write(struct.pack("<fI", float(s), len(t)))
                f.write(t)

    # -- encode/decode (llama2.c greedy score-BPE) ---------------------------

    def encode(self, s: str, bos: bool = False, eos: bool = False) -> list[int]:
        ids: list[int] = []
        data = s.encode("utf-8")
        # SentencePiece add_dummy_prefix convention (llama2.c run.c encode():
        # non-empty text gets the " " token prepended before byte/BPE merging).
        if data:
            sp = self.lookup.get(b" ")
            if sp is not None:
                ids.append(sp)
        for byte in data:
            tok = bytes([byte])
            if tok in self.lookup:
                ids.append(self.lookup[tok])
            else:
                ids.append(byte + BYTE_FALLBACK_OFFSET)
        # Greedy merges: repeatedly join the adjacent pair whose merged
        # string exists in the vocab with the best score.
        while True:
            best_score, best_i, best_id = -1e10, -1, -1
            for i in range(len(ids) - 1):
                merged = self._bytes(ids[i]) + self._bytes(ids[i + 1])
                j = self.lookup.get(merged)
                if j is not None and self.scores[j] > best_score:
                    best_score, best_i, best_id = self.scores[j], i, j
            if best_i < 0:
                break
            ids[best_i:best_i + 2] = [best_id]
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return ids

    def _bytes(self, tid: int) -> bytes:
        if 0 <= tid < len(self.tokens) and self.tokens[tid]:
            return self.tokens[tid]
        if BYTE_FALLBACK_OFFSET <= tid < BYTE_FALLBACK_OFFSET + 256:
            return bytes([tid - BYTE_FALLBACK_OFFSET])
        return b""

    def decode(self, ids: list[int], bos: bool = False) -> str:
        """ids -> text. ``bos=True`` means the ids directly follow a BOS
        token: per SentencePiece/llama2.c convention the dummy-prefix space
        of the first piece is stripped (run.c ``decode()``)."""
        out = b"".join(self._bytes(int(t)) for t in ids)
        if bos and out.startswith(b" "):
            out = out[1:]
        return out.decode("utf-8", errors="replace")


def byte_tokenizer(vocab_size: int = 512) -> Tokenizer:
    """A trivially self-contained tokenizer: ids 3..258 are raw bytes.

    Mirrors llama2.c's byte-fallback region so models trained with it decode
    identically; useful for tests and for running without a SentencePiece
    export.
    """
    tokens: list[bytes] = [b"<unk>", b"\n<s>\n", b"\n</s>\n"]
    scores: list[float] = [0.0, 0.0, 0.0]
    for b in range(256):
        tokens.append(bytes([b]))
        scores.append(-float(b))
    while len(tokens) < vocab_size:
        tokens.append(b"")
        scores.append(-1e9)
    return Tokenizer(tokens[:vocab_size], scores[:vocab_size])
