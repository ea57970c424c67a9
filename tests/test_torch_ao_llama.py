"""AO-Llama parity: the port's ``Llama`` Lua surface against the reference
``Process``, case for case with tests/test_ao_llama.py.

The tiny golden model (tests/data, goldens from the independent float64
oracle tests/llama_oracle.py) is driven through ``Process.handle`` Eval
chunks on both packages, over both model channels (the publish chain and the
WeaveDrive-analog virtual FS); every response's output and error must be
the reference's exact string.  The port runs on the CPU here.
"""

import json
import os

import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import params as jax_params
from eoc_tfhe_tpu.process import Process as JaxProcess
from eoc_tfhe_tpu_torch.core import params
from eoc_tfhe_tpu_torch.io.virtualfs import LocalBackend, VirtualFS
from eoc_tfhe_tpu_torch.models import publish, tokenizer
from eoc_tfhe_tpu_torch.models.ao_llama import LlamaBackend
from eoc_tfhe_tpu_torch.process import Process

_DATA = os.path.join(os.path.dirname(__file__), "data")
ENV = json.dumps({"Process": {"Id": "AOS", "Owner": "FOOBAR", "Module": "M1"}})


def _msg(src):
    return json.dumps({"Tags": [{"name": "Action", "value": "Eval"}],
                       "Data": src, "Block-Height": 100})


def _eval(p, src):
    r = json.loads(p.handle(_msg(src), ENV))
    assert r["Error"] is None, r["Error"]
    return r["Output"]["data"]["output"]


def _twins(**kw):
    """(port Process on the CPU, reference Process) over the same backends."""
    return (Process(params=params.test_params(), device="cpu", **kw),
            JaxProcess(params=jax_params.test_params(), **kw))


def _same(chunks, **kw):
    """Run the Eval chunks on both processes; every reply must be the
    reference's string. Returns the port's outputs."""
    port, ref = _twins(**kw)
    outs = []
    for src in chunks:
        got, want = json.loads(port.handle(_msg(src), ENV)), json.loads(ref.handle(_msg(src), ENV))
        assert got == want, src
        outs.append(got["Output"]["data"]["output"])
    return outs


def _model_bytes():
    with open(os.path.join(_DATA, "llama_tiny_v0.bin"), "rb") as f:
        model = f.read()
    with open(os.path.join(_DATA, "llama_tiny_tok.bin"), "rb") as f:
        tok = f.read()
    return model, tok


def _golden_text():
    gold = np.load(os.path.join(_DATA, "llama_tiny_golden.npz"))
    tok = tokenizer.Tokenizer.load(os.path.join(_DATA, "llama_tiny_tok.bin"))
    return gold, "".join(tok.decode([int(t)]) for t in gold["generated"][0])


@pytest.fixture()
def store(tmp_path):
    """The tiny golden model published as the Next-linked chain (two chunks,
    so the walk is exercised)."""
    st = publish.LocalStore(str(tmp_path / "items"))
    model, tok = _model_bytes()
    head = publish.publish_model(st, model, tok, chunk_size=len(model) // 2 + 1)
    return st, head


def test_backend_matches_oracle_golden(store):
    st, head = store
    gold, _txt = _golden_text()
    be = LlamaBackend(store=st, device="cpu")
    be.load(head)
    ids = be.generated_ids("hello world", 8)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, gold["generated"][0])
    assert be.device == torch.device("cpu") and be.model.params["wq"].device.type == "cpu"


def test_llama_through_process_eval(store):
    """FHE and the LLM in one process, driven from the same Eval chunks."""
    st, head = store
    _, text = _golden_text()
    outs = _same(["return Llama.info()", f'Llama.load("{head}")',
                  'Llama.setPrompt("hello world")', "return Llama.run(8)"], model_store=st)
    assert "llama.cpp" in outs[0] and outs[3] == text
    port = Process(params=params.test_params(), model_store=st, device="cpu")
    _eval(port, f'Llama.load("{head}")')
    _eval(port, 'Llama.setPrompt("hello world")')
    assert _eval(port, "return Llama.run(8)") == text
    _eval(port, 'key = Tfhe.generateSecretKey("h.p", "")')
    assert _eval(port, 'return Tfhe.decryptInteger('
                       'Tfhe.encryptInteger(42, ""), "", "h.p", "")') == "42"


def test_llama_next_add_incremental(store):
    st, head = store
    _, text = _golden_text()
    outs = _same([f'Llama.load("{head}")', 'Llama.setPrompt("hello world")']
                 + ["return Llama.next()"] * 8
                 + ['Llama.stop()', 'Llama.setPrompt("hello")', 'Llama.add(" world")',
                    "return Llama.run(8)"], model_store=st)
    assert "".join(outs[2:10]) == text
    # "hello" + " world" tokenizes apart from "hello world"; the incremental
    # path must be deterministic across processes
    again = _same([f'Llama.load("{head}")', 'Llama.setPrompt("hello")',
                   'Llama.add(" world")', "return Llama.run(8)"], model_store=st)
    assert again[-1] == outs[-1]


def test_llama_via_virtualfs(tmp_path):
    """Flat-item channel: the model and <id>.tokenizer through the WeaveDrive
    analog."""
    model, tok = _model_bytes()
    (tmp_path / "m1").write_bytes(model)
    (tmp_path / "m1.tokenizer").write_bytes(tok)
    vfs = VirtualFS(LocalBackend(str(tmp_path)))
    _, text = _golden_text()
    outs = _same(['Llama.load("m1")', 'Llama.setPrompt("hello world")',
                  "return Llama.run(8)"], vfs=vfs)
    assert outs[-1] == text


def test_llama_log_plumbing(store):
    st, head = store
    n, again = _same([f'Llama.load("{head}")', 'return #Llama.log["info"]',
                      'Llama.logLevel = 2', f'Llama.load("{head}")',
                      'return #Llama.log["info"]'], model_store=st)[1::3]
    assert int(n) >= 1 and again == n


def test_utf8_pieces_buffer_across_tokens(store):
    """A multi-byte UTF-8 character split across byte-fallback tokens must
    not decode to replacement characters piecewise."""
    st, head = store
    be = LlamaBackend(store=st, device="cpu")
    be.load(head)
    assert be._emit_piece(3 + 0xC3) == ""
    assert be._emit_piece(3 + 0xA9) == "é"
    assert be._utf8_buf == b""
    assert be._emit_piece(3 + 0xC3) == ""
    assert be._emit_piece(3 + ord("x")).endswith("x")


def test_backend_and_process_llama_default_to_the_card(store, monkeypatch):
    """No path falls back to the CPU: without a card the backend refuses, and
    so does a Process's first Llama call on the default device."""
    st, head = store
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaBackend(store=st)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Process(params=params.test_params(), model_store=st)
