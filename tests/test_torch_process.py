"""The port's Lua/AO process runtime against the JAX package's.

The reference's Lua chunks (``tests/test_lua_runtime.py``,
``tests/test_process.py``) run on the reference's ``Process`` and on the
port's ``Process(device="cpu")`` with the same messages.  Keygen and
encryption draw from different PRNGs, so ciphertext and key strings are held
by their length only; everything else must be equal: every decrypted output,
the ``Info`` text, ``print`` output, the ``Error`` strings of Lua and sandbox
errors, the ``.crypto`` stream and the ``Messages`` that ``Router`` routes.
The port's ``replay()`` must give byte-identical responses, and its
``lua.py`` must be the reference's code.
"""

import ast
import json
from pathlib import Path

import pytest
import torch

from eoc_tfhe_tpu import lua as jlua
from eoc_tfhe_tpu.core.params import test_params as jtest_params
from eoc_tfhe_tpu.process import Process as JProcess
from eoc_tfhe_tpu.process import Router as JRouter

from eoc_tfhe_tpu_torch import lua
from eoc_tfhe_tpu_torch.core import params
from eoc_tfhe_tpu_torch.process import Process, Router, _seed_from_env

ENV = json.dumps({"Process": {"Id": "AOS", "Owner": "FOOBAR", "Module": "M1"}})
_ROOT = Path(__file__).resolve().parents[1]


def eval_msg(data, block="1000"):
    return json.dumps({
        "Target": "AOS", "From": "FOOBAR", "Owner": "FOOBAR",
        "Block-Height": block, "Id": "test", "Module": "TFHE",
        "Tags": [{"name": "Action", "value": "Eval"}], "Data": data})


def msg(action, data="", **tags):
    t = [{"name": "Action", "value": action}]
    t += [{"name": k, "value": str(v)} for k, v in tags.items()]
    return json.dumps({"Tags": t, "Data": data, "Block-Height": 100})


def pair(**kw):
    """The reference's process and the port's, built alike."""
    return (JProcess(params=jtest_params(), **kw),
            Process(params=params.test_params(), device="cpu", **kw))


def both(procs, message, env=ENV, blob=False):
    """One message to both processes; the port's parsed response, after
    checking it against the reference's (a ciphertext or key output, with
    ``blob``, by its length only)."""
    j, t = (json.loads(p.handle(message, env)) for p in procs)
    assert t["Error"] == j["Error"]
    assert t["Messages"] == j["Messages"]
    jo, to = j["Output"]["data"]["output"], t["Output"]["data"]["output"]
    if blob:
        assert len(to) == len(jo) and len(to) > 0
    else:
        assert to == jo
    return t


def out(resp):
    assert resp["Error"] is None, resp["Error"]
    return resp["Output"]["data"]["output"]


# --- tests/test_lua_runtime.py ----------------------------------------------------

#: The reference integration cases 2-6, verbatim (test_lua_runtime.py), with
#: the port's expected output.
REFERENCE_CASES = {
    "info": ('''
        local tfhe = require(".tfhe")
        local info = tfhe.info()
        tfhe.testJWT();
        print(info)
        return "OK"
      ''', None),
    "int_roundtrip": ('''
        local tfhe = require(".tfhe")

        -- Generate secret key first
        tfhe.generateSecretKey("h.p", "")

        -- Test integer encryption/decryption
        local original = 42
        local encrypted = tfhe.encryptInteger(original, '')
        local decrypted = tfhe.decryptInteger(encrypted, '', "h.p", "")

        return tostring(decrypted)
      ''', "42"),
    "string_roundtrip": ('''
        local tfhe = require(".tfhe")

        local text = "Hello TFHE!"
        local encrypted = tfhe.encryptASCIIString(text, #text, '')
        local decrypted = tfhe.decryptASCIIString(encrypted, #text, '', "h.p", "")

        return decrypted
      ''', "Hello TFHE!"),
    "addition": ('''
        local tfhe = require(".tfhe")

        local a = 15
        local b = 27

        local enc_a = tfhe.encryptInteger(a, '')
        local enc_b = tfhe.encryptInteger(b, '')

        local enc_sum = tfhe.addCiphertexts(enc_a, enc_b, '')
        local sum = tfhe.decryptInteger(enc_sum, '', "h.p", "")

        return tostring(sum)
      ''', "42"),
    "subtraction": ('''
        local tfhe = require(".tfhe")

        local a = 50
        local b = 8

        local enc_a = tfhe.encryptInteger(a, '')
        local enc_b = tfhe.encryptInteger(b, '')

        local enc_diff = tfhe.subtractCiphertexts(enc_a, enc_b, '')
        local diff = tfhe.decryptInteger(enc_diff, '', "h.p", "")

        return tostring(diff)
      ''', "42"),
}


@pytest.fixture(scope="module")
def case_pair():
    """One pair of processes for the reference cases, which share their
    state as the reference's do; the key is made first, so that no case
    depends on another's order."""
    procs = pair()
    out(both(procs, msg("GenerateSecretKey", Token="h.p"), blob=True))
    return procs


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_reference_lua_cases(case_pair, case):
    chunk, want = REFERENCE_CASES[case]
    got = out(both(case_pair, eval_msg(chunk)))
    if want is None:
        assert "TFHE" in got and got.endswith("OK")
    else:
        assert got == want


def test_handlers_pattern_matched_dispatch():
    procs = pair()
    out(both(procs, eval_msg('''
        counter = 0
        Handlers.add("ping",
          Handlers.utils.hasMatchingTag("Action", "Ping"),
          function (msg)
            counter = counter + 1
            ao.send({ Target = msg.From, Data = "pong " .. counter })
            return "ponged " .. msg.From
          end)
        Handlers.add("echo-data",
          function (msg) return msg.Action == "Echo" end,
          function (msg) return "echo:" .. msg.Data end)
        return "registered"
      ''')))
    ping = json.dumps({"From": "caller-1", "Block-Height": 100,
                       "Tags": [{"name": "Action", "value": "Ping"}]})
    r = both(procs, ping)
    assert out(r) == "ponged caller-1" and r["Messages"][0]["Data"] == "pong 1"
    echo = json.dumps({"From": "x", "Block-Height": 100, "Data": "hi",
                       "Tags": [{"name": "Action", "value": "Echo"}]})
    assert out(both(procs, echo)) == "echo:hi"
    nope = json.dumps({"Tags": [{"name": "Action", "value": "Nope"}]})
    assert "no handler" in both(procs, nope)["Error"]
    assert both(procs, ping)["Messages"][0]["Data"] == "pong 2"


def test_crypto_module_matches_reference_stream():
    """.crypto: the same chain coordinates give the reference's numbers."""
    prog = '''
        local c = require(".crypto")
        local a = c.integer(1, 1000000)
        local b = c.integer(1, 1000000)
        return a .. "," .. b
    '''
    o1 = out(both(pair(), eval_msg(prog)))
    env2 = json.dumps({"Process": {"Id": "OTHER", "Owner": "X", "Module": "M"}})
    assert out(both(pair(), eval_msg(prog), env=env2)) != o1


def test_eval_state_persists_and_json(case_pair):
    out(both(case_pair, eval_msg('stash = json.encode({k = "v"})')))
    assert out(both(case_pair, eval_msg('return json.decode(stash).k'))) == "v"


@pytest.mark.parametrize("router_cls", [Router, JRouter])
def test_router_with_lua_handlers(router_cls):
    """Both packages' routers deliver the same Messages between the port's
    processes as the reference's router between its own."""
    responses = []
    for R, P in ((JRouter, lambda pid: JProcess(params=jtest_params(), process_id=pid)),
                 (router_cls, lambda pid: Process(params=params.test_params(), process_id=pid,
                                                  device="cpu"))):
        router = R()
        router.register(P("alice"))
        router.register(P("bob"))
        router.push("bob", {"Tags": [{"name": "Action", "value": "Eval"}], "Data": '''
            Handlers.add("greet",
              Handlers.utils.hasMatchingTag("Action", "Greet"),
              function (msg) return "hello " .. msg.From end)
            return "ok"'''})
        responses.append(router.push("alice", {
            "Tags": [{"name": "Action", "value": "Send"}, {"name": "Target", "value": "bob"},
                     {"name": "Forward-Action", "value": "Greet"}],
            "Data": ""}))
    assert responses[1] == responses[0]
    assert responses[1][1]["Output"]["data"]["output"] == "hello alice"


#: The interpreter programs of test_lua_runtime.py's hardening tests.
LUA_PROGRAMS = [
    """local acc = {}
       for i = 1, 5 do acc[#acc + 1] = i * i end
       local j, total = 1, 0
       while j <= #acc do total = total + acc[j]; j = j + 1 end
       repeat total = total + 1 until total > 55
       local obj = { n = 0 }
       function obj:bump(k) self.n = self.n + k; return self.n end
       obj:bump(3); obj:bump(4)
       local s = "a,b,c"
       local head = s:sub(1, (s:find(",")) - 1)
       return total, obj.n, table.concat(acc, "-"), head,
              ("%d/%s"):format(7, "x"), 2^10, 7 // 2, 7 % 3, -2 < 1,
              not nil, "x" ~= "y\"""",
    "return string.rep('aaaaaaaa', 2^40)",
    "local s = 'xxxxxxxxxxxxxxxx' for i = 1, 40 do s = s .. s end return #s",
    "return string.format('%999999999d', 1)",
    "local spec = string.rep('%1000000d', 20) return string.format(spec, "
    + ", ".join(["7"] * 20) + ")",
    "return string.rep('ab', 3, '-')",
    "return ('x'):rep(4) .. 'y'",
    "x = 5 local function f() local x = nil return x end return f(), x",
    "local ok, e = pcall(string.rep, 'a', 'zz'); return ok, e",
    "return string.format('abc%')",
    "return string.format('%d %d', 1)",
    "local ok, e = pcall(string.format, 'x%'); return ok",
    'return string.gsub("aaa", "a", "b", 0)',
    'return string.gsub("abc", "b", "[%0]")',
    'return string.gsub("x", "x", "100%%")',
    'return string.gsub("ab", "a", "<%1>")',
    'return string.byte("abc", -1)',
    'return string.match("l1\\nl2", "(.*)")',
    'return string.find("a^b", "a^b")',
    'return string.find("x", "x%")',
    'math.randomseed(42); return math.random(1, 10^9)',
    '''__interp__ = nil
       local t = {}
       for i = 1, 200 do t[i] = string.rep("x", 7000000) end
       return #t''',
]


@pytest.mark.parametrize("i", range(len(LUA_PROGRAMS)))
def test_interpreter_programs_match_reference(i):
    def run(mod):
        G = mod.make_stdlib(print_sink=lambda s: None, modules={})
        try:
            return "ok", mod.run(LUA_PROGRAMS[i], G)[0]
        except mod.LuaError as exc:
            return "error", str(exc)
    assert run(lua) == run(jlua)


def test_lua_module_is_the_reference_code():
    """``lua.py`` is the reference's interpreter statement for statement:
    the two syntax trees agree once docstrings are removed."""
    def tree(path):
        t = ast.parse(path.read_text())
        for node in ast.walk(t):
            body = getattr(node, "body", None)
            if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                    and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        return ast.dump(t)
    assert (tree(_ROOT / "eoc_tfhe_tpu_torch" / "lua.py")
            == tree(_ROOT / "eoc_tfhe_tpu" / "lua.py"))


# --- tests/test_process.py ------------------------------------------------------

def test_process_full_flow():
    procs = pair()
    assert "TFHE Library" in out(both(procs, msg("Info")))
    out(both(procs, msg("GenerateSecretKey", Token="h.p"), blob=True))
    ports = procs[1]

    def enc(v):
        return [out(json.loads(p.handle(msg("EncryptInteger", Value=v), ENV))) for p in procs]

    def dec(cts):
        return [out(json.loads(p.handle(msg("DecryptInteger", data=c, Token="h.p"), ENV)))
                for p, c in zip(procs, cts)]
    assert dec(enc(42)) == ["42", "42"]
    c1, c2 = enc(15), enc(27)
    s = [out(json.loads(p.handle(msg("AddCiphertexts", data=json.dumps([a, b])), ENV)))
         for p, a, b in zip(procs, c1, c2)]
    assert len(s[0]) == len(s[1]) and dec(s) == ["42", "42"]
    d = [out(json.loads(p.handle(msg("SubtractCiphertexts", data=json.dumps([a, b])), ENV)))
         for p, a, b in zip(procs, enc(50), enc(8))]
    assert dec(d) == ["42", "42"]
    assert ports.tfhe._s.device == torch.device("cpu")


def test_process_string_roundtrip():
    procs = pair()
    out(both(procs, msg("GenerateSecretKey", Token="h.p"), blob=True))
    cts = [out(json.loads(p.handle(msg("EncryptASCIIString", data="Hello TFHE!"), ENV)))
           for p in procs]
    assert len(cts[0]) == len(cts[1])
    got = [out(json.loads(p.handle(msg("DecryptASCIIString", data=c, Token="h.p", Length=11),
                                   ENV))) for p, c in zip(procs, cts)]
    assert got == ["Hello TFHE!"] * 2


def test_process_error_surface():
    procs = pair()
    assert "no handler" in both(procs, msg("NoSuchAction"))["Error"]
    out(both(procs, msg("GenerateSecretKey", Token="h.p"), blob=True))
    # a corrupt ciphertext is an error in both (the codecs word it differently)
    for p in procs:
        r = json.loads(p.handle(msg("DecryptInteger", data="!!!corrupt!!!", Token="h.p"), ENV))
        assert r["Error"] is not None and r["Messages"] == []


def test_eval_handler_reference_style():
    procs = pair()
    assert "TFHE Library" in out(both(procs, msg("Eval", data='Tfhe.info()')))
    assert out(both(procs, msg("Eval", data='key = Tfhe.generateSecretKey("h.p", "")'))) == ""
    assert out(both(procs, msg("Eval", data='ct = Tfhe.encryptInteger(42, "")'))) == ""
    assert out(both(procs, msg("Eval", data='Tfhe.decryptInteger(ct, "", "h.p", "")'))) == "42"
    prog = ('a = Tfhe.encryptInteger(15, "")\n'
            'b = Tfhe.encryptInteger(27, "")\n'
            's = Tfhe.addCiphertexts(a, b, "")\n'
            'Tfhe.decryptInteger(s, "", "h.p", "")')
    assert out(both(procs, msg("Eval", data=prog))) == "42"


def test_eval_rejects_escapes_with_the_reference_errors():
    procs = pair()
    out(both(procs, msg("GenerateSecretKey", Token="h.p"), blob=True))
    for bad in ["__import__('os')", "open('/etc/passwd')",
                "import os", "Tfhe.__class__()", "(lambda: 1)()",
                "getattr(Tfhe, '_s')", "os.execv('/bin/sh', {})",
                "error('boom')", "return 1 +", "return nil .. 'x'"]:
        assert both(procs, msg("Eval", data=bad))["Error"] is not None, bad
    assert out(both(procs, msg("Eval", data="return Tfhe._s"))) == ""


def test_router_delivers_between_processes():
    responses = []
    for R, P in ((JRouter, lambda pid: JProcess(params=jtest_params(), process_id=pid)),
                 (Router, lambda pid: Process(params=params.test_params(), process_id=pid,
                                              device="cpu"))):
        router = R()
        router.register(P("alice"))
        router.register(P("bob"))
        key = router.push("bob", {"Tags": [{"name": "Action", "value": "GenerateSecretKey"},
                                           {"name": "Token", "value": "h.p"}]})
        responses.append((len(key[0]["Output"]["data"]["output"]), router.push("alice", {
            "Tags": [{"name": "Action", "value": "Send"}, {"name": "Target", "value": "bob"},
                     {"name": "Forward-Action", "value": "Eval"}],
            "Data": 'Tfhe.info()'})))
    assert responses[1] == responses[0]
    assert "TFHE Library" in responses[1][1][1]["Output"]["data"]["output"]


def test_published_module_readme_program():
    procs = pair(process_id="readme-proc", process_env={"JWT_TOKEN": "h.p", "JWKS": ""})
    env = json.dumps({"Process": {"Id": "readme-proc", "Owner": "F", "Module": "M1"}})

    def message(action, data, block):
        return json.dumps({"Target": "readme-proc", "From": "F", "Owner": "F",
                           "Block-Height": block, "Id": "m", "Module": "M",
                           "Tags": [{"name": "Action", "value": action}], "Data": data})
    got = out(both(procs, message("Eval", """
        local tfhe = Process.load("9qK8gsMKL2ZVOyP7DlPnEXKh_li2Fl_6liydOjprnPQ")
        local secret_key = tfhe.generateSecretKey(Process.env.JWT_TOKEN, Process.env.JWKS)
        local encrypted_a = tfhe.encryptInteger(42, '')
        local encrypted_b = tfhe.encryptInteger(23, '')
        local encrypted_sum = tfhe.addCiphertexts(encrypted_a, encrypted_b, '')
        local result = tfhe.decryptInteger(encrypted_sum, '', Process.env.JWT_TOKEN, Process.env.JWKS)
        return "The sum is: " .. result
    """, "1"), env=env))
    assert got.endswith("The sum is: 65")
    out(both(procs, message("Eval", """
        state = { encrypted_data = {} }
        local tfhe = Process.load("tfhe")
        Handlers.add("encrypt", function(msg)
            local value = tonumber(msg.Data)
            table.insert(state.encrypted_data, tfhe.encryptInteger(value, ''))
            return "Value encrypted and stored"
        end)
        Handlers.add("compute-sum", function(msg)
            local sum = state.encrypted_data[1]
            for i = 2, #state.encrypted_data do
                sum = tfhe.addCiphertexts(sum, state.encrypted_data[i], '')
            end
            return "Sum of encrypted values: " ..
                tfhe.decryptInteger(sum, '', Process.env.JWT_TOKEN, '')
        end)
        return "registered"
    """, "1"), env=env))
    assert "stored" in out(both(procs, message("encrypt", "15", "2"), env=env))
    assert "stored" in out(both(procs, message("encrypt", "27", "2"), env=env))
    assert out(both(procs, message("compute-sum", "", "2"), env=env)).endswith(
        "Sum of encrypted values: 42")
    r = both(procs, message("Eval", "return Process.load('not-a-module')", "3"), env=env)
    assert "unknown module" in r["Error"]


UINT8_CHUNKS = {
    "plain": ("""
            Tfhe.generateSecretKey('h.p', '')
            local a = Tfhe.encryptUint8(50, '')
            local b = Tfhe.encryptUint8(8, '')
            local d = Tfhe.subtractUint8(a, b, '')
            local m = Tfhe.multiplyUint8(a, b, '')
            local lt = Tfhe.lessThanUint8(b, a, '')
            local mn = Tfhe.selectUint8(lt, b, a, '')
            return 'diff=' .. Tfhe.decryptUint8(d, '', 'h.p', '')
                .. ' prod=' .. Tfhe.decryptUint8(m, '', 'h.p', '')
                .. ' min=' .. Tfhe.decryptUint8(mn, '', 'h.p', '')
        """, "diff=42 prod=144 min=8"),
    "seeded": ("""
            Tfhe.generateSecretKey('h.p', '')
            local a = Tfhe.encryptUint8Seeded(50, '')
            local b = Tfhe.encryptUint8(8, '')
            local d = Tfhe.subtractUint8(a, b, '')
            local s = Tfhe.addUint8(a, b, '')
            local roundtrip = Tfhe.decryptUint8(Tfhe.encryptUint8Seeded(7, ''), '', 'h.p', '')
            return 'diff=' .. Tfhe.decryptUint8(d, '', 'h.p', '') .. ' sum='
                .. Tfhe.decryptUint8(s, '', 'h.p', '') .. ' rt=' .. roundtrip
                .. ' len=' .. #a .. '/' .. #b
        """, "diff=42 sum=58 rt=7 len="),
}


@pytest.mark.parametrize("case", list(UINT8_CHUNKS))
def test_bootstrapped_uint8_via_lua(case):
    """The reference's uint8 chunks (plain and seeded uploads): the same
    decrypted values and blob lengths."""
    chunk, want = UINT8_CHUNKS[case]
    procs = pair(process_id="u8")
    env = json.dumps({"Process": {"Id": "u8", "Owner": "F", "Module": "M"}})
    message = json.dumps({"Target": "u8", "From": "F", "Owner": "F", "Block-Height": "1",
                          "Id": "m", "Module": "M",
                          "Tags": [{"name": "Action", "value": "Eval"}], "Data": chunk})
    got = out(both(procs, message, env=env))
    assert want in got
    if case == "seeded":
        la, lb = got.split("len=")[1].split("/")
        assert int(la) < int(lb)


# --- the port's own guarantees --------------------------------------------------

def _messages():
    return [msg("Info"), msg("GenerateSecretKey", Token="h.p"),
            eval_msg('a = Tfhe.encryptUint8Seeded(50, "")'),
            eval_msg('b = Tfhe.encryptUint8(8, "")'),
            eval_msg('return Tfhe.decryptUint8(Tfhe.subtractUint8(a, b, ""), "", "h.p", "")'),
            eval_msg('c = Tfhe.encryptInteger(15, "") return c')]


def test_replay_is_byte_identical():
    p = Process(params=params.test_params(), process_id="AOS", device="cpu")
    first = [p.handle(m, ENV) for m in _messages()]
    assert json.loads(first[4])["Output"]["data"]["output"] == "42"
    # the log replayed on a fresh process answers every message with the same bytes
    fresh = Process(params=params.test_params(), process_id="AOS", device="cpu")
    assert [fresh.handle(m, e) for m, e in p.log] == first
    # replay() and from_log rebuild the same state on the same device: the
    # next message gives the same bytes (the generators stand at one place)
    replicas = [p.replay(), Process.from_log(p.log, params=params.test_params(), device="cpu")]
    assert replicas[0].log == p.log and replicas[0].id == "AOS"
    nxt = eval_msg('return Tfhe.encryptUint8(9, "")', block="2000")
    want = p.handle(nxt, ENV)
    for q in replicas:
        assert q.device == torch.device("cpu")
        assert q.handle(nxt, ENV) == want


def test_process_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Process(params=params.test_params())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Process.from_log([], params=params.test_params())


def test_seed_matches_reference_and_fits_a_generator():
    from eoc_tfhe_tpu.process import _seed_from_env as jseed
    env = json.loads(ENV)
    for block in (0, 100, "1000", 2**40):
        m = {"Block-Height": block}
        seed = _seed_from_env(env, m)
        assert seed == jseed(env, m) and 0 <= seed < 2**63
        torch.Generator().manual_seed(seed)


def test_llama_is_registered_and_refuses_deterministically(tmp_path):
    """The twin of tests/test_ao_llama.py::test_llama_error_surface: with no
    model loaded, an id that no backend resolves, and no prompt, the port's
    process answers with the reference's exact error strings, the same on a
    repeat, and keeps evaluating afterwards."""
    from eoc_tfhe_tpu_torch.io.virtualfs import LocalBackend, VirtualFS
    from eoc_tfhe_tpu_torch.models.ao_llama import LlamaBackend, LlamaBackendError

    data = Path(__file__).resolve().parent / "data"
    (tmp_path / "m1").write_bytes((data / "llama_tiny_v0.bin").read_bytes())
    (tmp_path / "m1.tokenizer").write_bytes((data / "llama_tiny_tok.bin").read_bytes())
    vfs = VirtualFS(LocalBackend(str(tmp_path)))
    chunks = ("return Llama.info()",
              "Llama.load('nope')",                                  # no backend
              "local ok, e = pcall(Llama.run, 3); return tostring(ok) .. ':' .. e",
              "return 1 + 1")
    seen = []
    for kw, srcs in (({}, chunks), ({"vfs": vfs}, chunks[1:2] + (
            "Llama.load('m1')",
            "local ok, e = pcall(Llama.next); return tostring(ok) .. ':' .. e",
            "return 1 + 1"))):
        p = Process(params=params.test_params(), device="cpu", **kw)
        q = JProcess(params=jtest_params(), **kw)
        replies = [json.loads(p.handle(eval_msg(src), ENV)) for src in srcs]
        assert replies == [json.loads(q.handle(eval_msg(src), ENV)) for src in srcs]
        assert json.loads(p.handle(eval_msg(srcs[0]), ENV)) == replies[0]
        assert out(replies[-1]) == "2"
        seen.append(replies)
    assert out(seen[0][0]).startswith("A decentralized LLM")
    assert seen[0][1]["Error"].startswith("LlamaBackendError: cannot resolve model id")
    assert out(seen[0][2]).startswith("false:") and "no model loaded" in out(seen[0][2])
    assert seen[1][0]["Error"].startswith("FileNotFoundError")
    assert out(seen[1][2]).startswith("false:") and "no prompt set" in out(seen[1][2])

    be = LlamaBackend(device="cpu")
    with pytest.raises(LlamaBackendError, match="cannot resolve"):
        be.load("nope")
    with pytest.raises(LlamaBackendError, match="no model loaded"):
        be.next()
    be = LlamaBackend(vfs=vfs, device="cpu")
    be.load("m1")
    with pytest.raises(LlamaBackendError, match="no prompt set"):
        be.next()
