"""The port's chunked model publisher against the reference's, case for case
with tests/test_publish.py: the same bytes published through either module
give the same item ids, tags and chain, and either module reads the other's
chain."""

import numpy as np
import pytest

from eoc_tfhe_tpu.models import publish as ref
from eoc_tfhe_tpu_torch.io.virtualfs import LocalBackend, VirtualFS
from eoc_tfhe_tpu_torch.models import publish


@pytest.fixture
def blobs(rng):
    model = rng.integers(0, 256, 2_500_00, dtype=np.uint8).tobytes()
    tok = rng.integers(0, 256, 1234, dtype=np.uint8).tobytes()
    return model, tok


def _items(root):
    return sorted((p.name, p.read_bytes()) for p in root.iterdir())


def test_publish_fetch_roundtrip(tmp_path, blobs):
    """Same head id and the same on-disk items as the reference; each module
    fetches the other's chain."""
    model, tok = blobs
    store = publish.LocalStore(str(tmp_path / "port"))
    ref_store = ref.LocalStore(str(tmp_path / "ref"))
    head = publish.publish_model(store, model, tok, chunk_size=64 * 1024)
    assert head == ref.publish_model(ref_store, model, tok, chunk_size=64 * 1024)
    assert _items(tmp_path / "port") == _items(tmp_path / "ref")
    assert publish.fetch_model(store, head) == (model, tok)
    assert publish.fetch_model(ref_store, head) == ref.fetch_model(store, head) == (model, tok)


def test_tag_schema_matches_reference(tmp_path, blobs):
    model, tok = blobs
    store = publish.LocalStore(str(tmp_path))
    head = publish.publish_model(store, model, tok, chunk_size=100 * 1024)
    tags = store.tags(head)
    assert tags["Data-Protocol"] == "Onchain-Llama" and tags["Type"] == "Model-Chunk"
    assert tags["Model-Size"] == str(len(model)) and tags["Tokenizer-Size"] == str(len(tok))
    assert "Next" in tags
    item, hops = head, 0
    while True:
        t = store.tags(item)
        if t["Type"] == "Tokenizer":
            assert "Next" not in t
            break
        assert t["Type"] == "Model-Chunk"
        item = t["Next"]
        hops += 1
    assert hops == -(-len(model) // (100 * 1024))


def test_single_chunk_and_empty_model(tmp_path):
    store = publish.LocalStore(str(tmp_path))
    head = publish.publish_model(store, b"tiny", b"tok", chunk_size=1 << 20)
    assert publish.fetch_model(store, head) == (b"tiny", b"tok")
    head2 = publish.publish_model(store, b"", b"tok2")
    assert publish.fetch_model(store, head2) == (b"", b"tok2")
    assert head2 == ref.publish_model(ref.LocalStore(str(tmp_path / "ref")), b"", b"tok2")
    with pytest.raises(ValueError, match="chunk_size"):
        publish.publish_model(store, b"x", b"t", chunk_size=0)


def test_published_items_readable_via_virtualfs(tmp_path, blobs):
    model, tok = blobs
    store = publish.LocalStore(str(tmp_path))
    head = publish.publish_model(store, model, tok, chunk_size=64 * 1024)
    vfs = VirtualFS(LocalBackend(str(tmp_path)))
    assert vfs.read_all(head) == model[:64 * 1024]


def test_malformed_chains_are_refused(tmp_path):
    """A chain cut before its tokenizer, and a Model-Size that disagrees,
    raise as in the reference."""
    store = publish.LocalStore(str(tmp_path))
    tail = store.put(b"b", {"Type": publish.TYPE_MODEL_CHUNK})
    head = store.put(b"a", {"Type": publish.TYPE_MODEL_CHUNK, "Next": tail})
    for m in (publish, ref):
        with pytest.raises(ValueError, match="without a Tokenizer"):
            m.fetch_model(store, head)
    tok = store.put(b"t", {"Type": publish.TYPE_TOKENIZER})
    bad = store.put(b"a", {"Type": publish.TYPE_MODEL_CHUNK, "Next": tok, "Model-Size": "9"})
    for m in (publish, ref):
        with pytest.raises(ValueError, match="Model-Size"):
            m.fetch_model(store, bad)
