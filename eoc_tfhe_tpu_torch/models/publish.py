"""Chunked model publisher: the analog of upstream ``scripts/publish-model``.

A copy of ``eoc_tfhe_tpu/models/publish.py`` (pure Python).  Upstream
uploads llama models to Arweave as a singly linked list of data items: the
tokenizer first (``Type: Tokenizer``, no ``Next``), then the model ``.bin``
split into fixed-size chunks uploaded tail-to-head, each tagged ``Next: <id
of the following item>``, so the head chunk's id is the single handle for the
whole model; the head additionally carries ``Model-Size`` and
``Tokenizer-Size`` tags.

This module reproduces that protocol over a pluggable content-addressed
:class:`Store` (the zero-egress default is a local directory laid out like
the :class:`~eoc_tfhe_tpu_torch.io.virtualfs.LocalBackend` item store, so
published models are directly loadable through the WeaveDrive-analog
virtual FS), and provides the reader that walks the ``Next`` chain back
into ``(model_bytes, tokenizer_bytes)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Protocol

DEFAULT_CHUNK_MB = 100  # publish-model default '-s': '100' (MB)

#: Tag schema of the reference uploader (publish-model:19-24).
DATA_PROTOCOL = "Onchain-Llama"
TYPE_MODEL_CHUNK = "Model-Chunk"
TYPE_TOKENIZER = "Tokenizer"


@dataclasses.dataclass
class DataItem:
    item_id: str
    tags: dict
    size: int


class Store(Protocol):
    """Where data items land. Implement ``put``/``get``/``tags`` for a real
    uploader (Turbo/S3/GCS); :class:`LocalStore` is the offline default."""

    def put(self, data: bytes, tags: dict) -> str: ...
    def get(self, item_id: str) -> bytes: ...
    def tags(self, item_id: str) -> dict: ...


class LocalStore:
    """Content-addressed directory store: ``<root>/<id>`` holds the payload,
    ``<root>/<id>.json`` the tags. Ids are sha256 of payload AND tags —
    like a real Arweave tx id, which covers the tags: hashing the payload
    alone made identical chunks collide, and a later put overwrote the
    earlier item's ``Next`` tag, corrupting the chain into a self-loop
    (e.g. an all-zero model whose chunks repeat)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def put(self, data: bytes, tags: dict) -> str:
        tag_bytes = json.dumps(tags, sort_keys=True).encode()
        item_id = hashlib.sha256(data + b"\x00" + tag_bytes).hexdigest()
        with open(os.path.join(self.root, item_id), "wb") as f:
            f.write(data)
        with open(os.path.join(self.root, item_id + ".json"), "w") as f:
            json.dump(tags, f, indent=1, sort_keys=True)
        return item_id

    def get(self, item_id: str) -> bytes:
        with open(os.path.join(self.root, item_id), "rb") as f:
            return f.read()

    def tags(self, item_id: str) -> dict:
        with open(os.path.join(self.root, item_id + ".json")) as f:
            return json.load(f)


def publish_model(store: Store, model: bytes, tokenizer: bytes,
                  chunk_size: int = DEFAULT_CHUNK_MB * 1024 * 1024,
                  extra_tags: dict | None = None) -> str:
    """Upload tokenizer + model chunks as the reference's linked list.

    Returns the head chunk id (the model handle). Upload order matches
    publish-model: tokenizer, then chunks N-1 .. 1, then chunk 0 with the
    size tags.
    """
    if chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    chunks = [model[o:o + chunk_size] for o in range(0, len(model), chunk_size)]
    if not chunks:
        chunks = [b""]

    def base_tags(typ: str, next_id: str | None) -> dict:
        tags = {"Content-Type": "application/octet-stream",
                "Data-Protocol": DATA_PROTOCOL, "Type": typ}
        if next_id is not None:   # reference filters out null Next tags
            tags["Next"] = next_id
        return tags

    last_id = store.put(tokenizer, base_tags(TYPE_TOKENIZER, None))
    for i in range(len(chunks) - 1, 0, -1):
        last_id = store.put(chunks[i], base_tags(TYPE_MODEL_CHUNK, last_id))
    head_tags = base_tags(TYPE_MODEL_CHUNK, last_id)
    head_tags["Model-Size"] = str(len(model))
    head_tags["Tokenizer-Size"] = str(len(tokenizer))
    head_tags.update(extra_tags or {})
    return store.put(chunks[0], head_tags)


def fetch_model(store: Store, head_id: str,
                max_items: int = 100_000) -> tuple[bytes, bytes]:
    """Walk the ``Next`` chain from the head chunk -> (model, tokenizer).

    The chain ends at the ``Type: Tokenizer`` item (uploaded first, no
    ``Next``), exactly inverting :func:`publish_model`.
    """
    parts: list[bytes] = []
    item_id: str | None = head_id
    tokenizer = b""
    for _ in range(max_items):
        if item_id is None:
            # a well-formed chain ALWAYS terminates at the Tokenizer item
            # (publish_model uploads it first, Next-less); a model chunk
            # without Next means a truncated/corrupt chain — reject it
            # rather than silently returning an empty tokenizer
            raise ValueError(
                "malformed chain: ended without a Tokenizer item")
        tags = store.tags(item_id)
        data = store.get(item_id)
        if tags.get("Type") == TYPE_TOKENIZER:
            tokenizer = data
            item_id = tags.get("Next")
            if item_id is not None:
                raise ValueError("tokenizer item must terminate the chain")
            break
        parts.append(data)
        item_id = tags.get("Next")
    else:
        raise ValueError(f"chain longer than max_items={max_items}")
    model = b"".join(parts)
    expect = store.tags(head_id).get("Model-Size")
    if expect is not None and int(expect) != len(model):
        raise ValueError(
            f"Model-Size tag {expect} != reassembled size {len(model)}")
    return model, tokenizer
