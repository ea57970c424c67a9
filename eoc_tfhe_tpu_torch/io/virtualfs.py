"""Lazy chunked virtual file store with read-ahead: the WeaveDrive analog.

A copy of ``eoc_tfhe_tpu/io/virtualfs.py`` (pure Python).  The upstream host
ships ``tests/weavedrive.js``: an Arweave-backed lazy virtual FS for the wasm
runtime with a 32 KB read-ahead cache, 128 MB chunking, and an
attestation/admissibility protocol (SURVEY.md §2.1).  The framework's
equivalent need is streaming large key blobs / model shards from a slow or
remote store without loading them whole, gated by the same availability
rules.

This module provides the same capability shape, backend-pluggable:

  * :class:`LocalBackend`: reads ranges from local files (the "test mode").
  * :class:`Backend` protocol: implement ``size(id)`` / ``read_range`` for a
    remote store (e.g. a gateway with HTTP range requests); network backends
    are intentionally not bundled.
  * :class:`VirtualFS`: open/read/close handles with chunked fetching and a
    read-ahead cache, mirroring weavedrive's ``open/read/close`` surface
    (``weavedrive.js:10-175``) and its cache/chunk geometry.
  * :class:`Admissibility`: the attestation/availability checks of
    ``weavedrive.js:220-342`` (``mode == "test"`` bypass, Extension tag
    gate, Assignments/Individual/Library availability modes) over a
    GraphQL-shaped query exchange; :class:`InProcessGateway` is the offline
    gateway fake that actually parses the emitted query strings.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Protocol

#: weavedrive.js:3-6 — cache/chunk geometry.
READ_AHEAD = 32 * 1024
CHUNK_SIZE = 128 * 1024 * 1024


class Backend(Protocol):
    def size(self, item_id: str) -> int: ...
    def read_range(self, item_id: str, start: int, end: int) -> bytes: ...


class LocalBackend:
    """Range reads from a local directory (the mode="test" analog)."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, item_id: str) -> str:
        p = os.path.normpath(os.path.join(self.root, item_id))
        if not p.startswith(os.path.abspath(self.root) + os.sep) and \
           p != os.path.abspath(self.root):
            p = os.path.join(self.root, os.path.basename(item_id))
        return p

    def size(self, item_id: str) -> int:
        return os.path.getsize(self._path(item_id))

    def read_range(self, item_id: str, start: int, end: int) -> bytes:
        with open(self._path(item_id), "rb") as f:
            f.seek(start)
            return f.read(end - start)


# --------------------------------------------------------------------------
# Admissibility / attestation (weavedrive.js:220-342)
# --------------------------------------------------------------------------

#: Valid Availability-Type values (weavedrive.js:238).
AVAILABILITY_MODES = ("Assignments", "Individual", "Library")


def get_tag_values(name: str, tags) -> list[str]:
    """All values of a tag (``getTagValues``, weavedrive.js:328-336).

    ``tags`` is the AO list-of-{name, value} shape (the reference helper
    reads ``.key`` while its callers pass ``.name`` items — one of the
    fixture's sloppy-JS spots; this implementation accepts both)."""
    out = []
    for t in tags or ():
        if t.get("name", t.get("key")) == name:
            out.append(t["value"])
    return out


def _first_tag(tags, name: str) -> str | None:
    vals = get_tag_values(name, tags)
    return vals[0] if vals else None


class Gateway(Protocol):
    """Where availability queries go (``mod.arweave.api.post('/graphql')``,
    weavedrive.js:338-342)."""

    def graphql(self, query: str) -> dict: ...


class InProcessGateway:
    """Offline Arweave-gateway fake: an in-memory transaction index plus a
    parser for the exact GraphQL query shape WeaveDrive emits — the query
    travels as a STRING and is parsed here, so the protocol (not just the
    boolean) is exercised (``weavedrive.js:259-308,338-342``)."""

    def __init__(self):
        self.transactions: list[dict] = []
        self.queries: list[str] = []     # protocol log (for tests/tracing)

    def add_transaction(self, owner: str, block: int, tags: dict) -> None:
        """Index a transaction: ``tags`` maps name -> value."""
        self.transactions.append({"owner": owner, "block": int(block),
                                  "tags": dict(tags)})

    # -- the GraphQL-shaped protocol ------------------------------------

    @staticmethod
    def _parse(query: str) -> dict:
        """Parse the transactions(...) filter from the query string."""
        m = re.search(r"owners\s*:\s*\[([^\]]*)\]", query)
        owners = re.findall(r'"([^"]*)"', m.group(1)) if m else []
        m = re.search(r"block\s*:\s*\{\s*min\s*:\s*(\d+)\s*,\s*max\s*:\s*(\d+)",
                      query)
        blk = (int(m.group(1)), int(m.group(2))) if m else (0, 2 ** 62)
        tags = {}
        for name, vals in re.findall(
                r'\{\s*name\s*:\s*"([^"]+)"\s*,\s*values\s*:\s*\[([^\]]*)\]',
                query):
            tags[name] = re.findall(r'"([^"]*)"', vals)
        return {"owners": owners, "block": blk, "tags": tags}

    def graphql(self, query: str) -> dict:
        self.queries.append(query)
        spec = self._parse(query)
        lo, hi = spec["block"]
        edges = []
        for tx in self.transactions:
            if spec["owners"] and tx["owner"] not in spec["owners"]:
                continue
            if not (lo <= tx["block"] <= hi):
                continue
            if any(tx["tags"].get(name) not in vals
                   for name, vals in spec["tags"].items()):
                continue
            edges.append({"node": {"tags": [
                {"name": k, "value": v} for k, v in tx["tags"].items()]}})
        return {"data": {"transactions": {"edges": edges}}}


class Admissibility:
    """``checkAdmissible`` (weavedrive.js:220-326), offline-complete.

    Args mirror the loader module fields the reference reads: ``mode``
    (``"test"`` bypasses everything, weavedrive.js:221-224), the chain
    ``block_height``, the module item's tags and the process spawn item's
    tags (AO list-of-{name, value} lists), and the gateway for availability
    queries.

    Divergences from the reference fixture, documented not copied:
      * ``processHasWeaveDrive`` there re-reads the MODULE tags
        (weavedrive.js:230 — a fixture bug); here the spawn tags are
        actually consulted, so a process can enable the extension itself.
      * the Individual-mode query there is malformed GraphQL (missing brace,
        weavedrive.js:293); the query emitted here is well-formed.
      * inadmissible opens raise :class:`PermissionError` instead of
        returning fd 0.
    """

    def __init__(self, gateway: Gateway | None = None, mode: str | None = None,
                 block_height: int = 0, module_tags=(), spawn_tags=()):
        self.gateway = gateway
        self.mode = mode
        self.block_height = int(block_height)
        self.module_tags = list(module_tags)
        self.spawn_tags = list(spawn_tags)

    # -- query builders (weavedrive.js:259-280, 287-308) -----------------

    def _attestation_query(self, scheduler: str, item_id: str) -> str:
        return (
            'query {\n  transactions(\n'
            f'    owners: ["{scheduler}"],\n'
            f'    block: {{min: 0, max: {self.block_height}}},\n'
            '    tags: [\n'
            '      { name: "Data-Protocol", values: ["ao"] },\n'
            '      { name: "Type", values: ["Attestation"] },\n'
            f'      {{ name: "Message", values: ["{item_id}"] }}\n'
            '    ]\n  )\n'
            '  { edges { node { tags { name value } } } }\n}')

    def _available_query(self, scheduler: str, item_id: str) -> str:
        return (
            'query {\n  transactions(\n'
            f'    owners: ["{scheduler}"],\n'
            f'    block: {{min: 0, max: {self.block_height}}},\n'
            '    tags: [\n'
            '      { name: "Data-Protocol", values: ["WeaveDrive"] },\n'
            '      { name: "Type", values: ["Available"] },\n'
            f'      {{ name: "ID", values: ["{item_id}"] }}\n'
            '    ]\n  )\n'
            '  { edges { node { tags { name value } } } }\n}')

    def _query_has_result(self, query: str) -> bool:
        out = self.gateway.graphql(query)
        return len(out["data"]["transactions"]["edges"]) > 0

    # -- the check itself -------------------------------------------------

    def check(self, item_id: str) -> bool:
        # test-mode bypass (weavedrive.js:221-224) — how the reference's
        # own TFHE test suite runs (tests/tfhe.test.js mode: "test")
        if self.mode == "test":
            return True

        # Extension gate (weavedrive.js:227-236)
        has_ext = ("WeaveDrive" in get_tag_values("Extension", self.module_tags)
                   or "WeaveDrive" in get_tag_values("Extension",
                                                     self.spawn_tags))
        if not has_ext:
            return False

        # Availability-Type: module default, spawn override (…:238-252)
        avail = (_first_tag(self.spawn_tags, "Availability-Type")
                 or _first_tag(self.module_tags, "Availability-Type")
                 or "Assignments")
        if avail not in AVAILABILITY_MODES:
            raise ValueError(f"Unsupported WeaveDrive mode: {avail}")

        scheduler = _first_tag(self.spawn_tags, "Scheduler") or ""
        if self.gateway is None:
            return False

        # Assignments form: every WeaveDrive process has it (…:258-284)
        if self._query_has_result(self._attestation_query(scheduler, item_id)):
            return True

        if avail == "Individual":
            if self._query_has_result(self._available_query(scheduler,
                                                            item_id)):
                return True

        if avail == "Library":
            # (…:315-323) signals 'Cannot Process', not a normal rejection
            raise NotImplementedError(
                "This WeaveDrive implementation does not support Library "
                "attestations yet!")
        return False


@dataclasses.dataclass
class _Handle:
    item_id: str
    size: int
    pos: int = 0
    cache_start: int = 0
    cache: bytes = b""


class VirtualFS:
    """open/read/close over a chunked backend with read-ahead."""

    def __init__(self, backend: Backend, read_ahead: int = READ_AHEAD,
                 admissibility: Admissibility | None = None):
        self.backend = backend
        self.read_ahead = read_ahead
        #: Optional attestation gate consulted at open() (weavedrive.js
        #: create():19-22 — inadmissible ids never become handles).  None =
        #: ungated (the reference's mode="test" deployment shape).
        self.admissibility = admissibility
        self._handles: dict[int, _Handle] = {}
        self._next_fd = 3

    def open(self, item_id: str) -> int:
        if self.admissibility is not None and \
                not self.admissibility.check(item_id):
            raise PermissionError(
                f"WeaveDrive: item id is not admissible: {item_id}")
        h = _Handle(item_id=item_id, size=self.backend.size(item_id))
        fd = self._next_fd
        self._next_fd += 1
        self._handles[fd] = h
        return fd

    def read(self, fd: int, length: int) -> bytes:
        h = self._handles[fd]
        length = min(length, h.size - h.pos)
        if length <= 0:
            return b""
        out = bytearray()
        while length > 0:
            # serve from cache when possible
            off = h.pos - h.cache_start
            if 0 <= off < len(h.cache):
                take = min(length, len(h.cache) - off)
                out += h.cache[off:off + take]
                h.pos += take
                length -= take
                continue
            # fetch next window (read-ahead, capped by chunk boundary and EOF)
            start = h.pos
            end = min(start + max(length, self.read_ahead), h.size,
                      (start // CHUNK_SIZE + 1) * CHUNK_SIZE)
            h.cache = self.backend.read_range(h.item_id, start, end)
            h.cache_start = start
        return bytes(out)

    def seek(self, fd: int, pos: int) -> None:
        self._handles[fd].pos = pos

    def close(self, fd: int) -> None:
        self._handles.pop(fd, None)

    def read_all(self, item_id: str) -> bytes:
        fd = self.open(item_id)
        try:
            return self.read(fd, self._handles[fd].size)
        finally:
            self.close(fd)
