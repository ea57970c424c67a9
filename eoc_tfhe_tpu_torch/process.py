"""Deterministic message-driven process runtime: the AO/aos analog.

Port of ``eoc_tfhe_tpu/process.py``, bound to the port's ``Tfhe``.  The
reference runs inside an AO "process": a deterministic Lua VM whose whole
state is a pure function of the message log, exposed to the host as one
wasm export ``handle(msgJSON, envJSON)``, with message dispatch through the
aos ``Handlers`` registry (SURVEY.md §3.1-3.2).  Determinism is what makes
replay possible: any node re-derives the state by replaying the messages.

  * :class:`Process`: a handler registry and a message log; ``handle(msg,
    env)`` takes and returns JSON strings like the wasm export.  It runs on
    the card unless ``device`` names another device, and raises without one.
  * Determinism by construction: the process seed derives from
    (Block-Height, Owner, Module, Id) like the aos ``.crypto`` RNG, and all
    crypto randomness comes from the ``Tfhe``'s ``torch.Generator`` seeded
    with it.  The kernels are exact, so a replay on the card gives the same
    bytes.
  * :meth:`Process.replay`: rebuild the same state from the message log.

Dispatch is by ``Action`` tag over the reference's operation set, plus:

  * ``Eval``: the aos ``_eval`` analog.  The message Data runs as a Lua
    program in the sandboxed interpreter (:mod:`eoc_tfhe_tpu_torch.lua`),
    with globals that persist across messages (the aos ``_G``),
    ``require(".tfhe")``, ``Handlers.add(name, matcher, fn)``, ``ao.send``,
    ``json`` and the deterministic ``.crypto`` RNG, so the reference's own
    integration-test chunks run verbatim.
  * Lua-registered ``Handlers``, tried in registration order for messages
    whose Action has no builtin handler, each with its aos-style matcher
    (``Handlers.utils.hasMatchingTag``).
  * ``Process.send`` and the response's ``Messages``: the ``ao.send``
    pattern; :class:`Router` delivers them between registered processes.

The ``Llama`` table is registered as in the reference's boot; its backend
(:class:`~eoc_tfhe_tpu_torch.models.ao_llama.LlamaBackend`) is made at the
first ``Llama.*`` call and runs the decoder on the process's device.
"""

from __future__ import annotations

import hashlib
import json
from typing import Callable

from . import lua
from .api.tfhe import Tfhe
from .core.params import GateBootstrappingParams
from .device import resolve_device


class EvalError(Exception):
    pass


#: Tfhe methods exposed to Lua (the luaL_Reg table of the reference's
#: bindings, ``eoc-tfhe-bindings.c:128-148``).
_TFHE_METHODS = ("info", "testJWT", "generateSecretKey", "generatePublicKey",
                 "encryptInteger", "encryptInteger_dummy", "decryptInteger",
                 "addCiphertexts", "subtractCiphertexts", "encryptASCIIString",
                 "decryptASCIIString",
                 # bootstrapped 8-bit arithmetic (beyond the reference's
                 # leveled-only ops; real noise-resetting circuits)
                 "encryptUint8", "encryptUint8Seeded", "decryptUint8",
                 "addUint8", "subtractUint8", "multiplyUint8",
                 "lessThanUint8", "equalsUint8", "selectUint8")


def _tfhe_bridge(t: Tfhe) -> lua.LuaTable:
    """Expose the Tfhe facade to Lua as a table of bound closures (no
    attribute traversal — the sandbox only sees these entries)."""
    table = lua.LuaTable()
    for name in _TFHE_METHODS:
        method = getattr(t, name, None)
        if method is None and name == "encryptInteger_dummy":
            method = t.encryptInteger          # the reference aliases it
        if method is None:
            continue

        def wrap(m=method):
            def call(*args):
                out = m(*args)
                return out
            return call
        table.set(name, wrap())
    return table


def _seed_from_env(env: dict, msg: dict) -> int:
    """Deterministic seed from chain coordinates (aos .crypto seeding scheme)."""
    proc = env.get("Process", {})
    material = "|".join(str(x) for x in (
        msg.get("Block-Height", 0), proc.get("Owner", ""),
        proc.get("Module", ""), proc.get("Id", "")))
    seed = int.from_bytes(hashlib.sha256(material.encode()).digest()[:8], "little")
    return seed & (2 ** 63 - 1)   # a signed 64-bit seed, as the reference's


class Process:
    """A deterministic TFHE process: state = f(message log)."""

    def __init__(self, params: GateBootstrappingParams | None = None,
                 process_id: str = "", process_env: dict | None = None,
                 model_store=None, vfs=None, device=None):
        self._params = params
        #: Where the process's ``Tfhe`` computes: the card unless named.
        self.device = resolve_device(device)
        self.id = process_id
        #: Process-creation environment (the ``--env K=V`` values of
        #: ``aos create-process``; surfaced to Lua as ``Process.env.K``).
        self.process_env = dict(process_env or {})
        #: Model-loading backends for the AO-Llama surface: a publish-chain
        #: store (models/publish.LocalStore or any Store) and/or a
        #: WeaveDrive-analog virtual FS (io/virtualfs.VirtualFS).  The
        #: ``Llama`` Lua table is always registered (as in the reference's
        #: boot); ``Llama.load`` fails deterministically when neither is given.
        self.model_store = model_store
        self.vfs = vfs
        self._llama_backend = None
        self.tfhe: Tfhe | None = None
        self.log: list[tuple[str, str]] = []
        self.handlers: dict[str, Callable[[dict, dict], str]] = {}
        self._outbox: list[dict] = []
        self._lua_G: lua.LuaTable | None = None
        self._lua_handlers: list[tuple[str, object, object]] = []
        self._prints: list[str] = []
        self._crypto = lua.Crypto(0)
        self._register_defaults()

    # -- outbound messages (``ao.send`` analog) -----------------------------

    def send(self, target: str, tags: dict | None = None,
             data: str = "") -> None:
        """Queue an outbound message; delivered in the response's
        ``Messages`` list (the AO pattern: processes communicate only
        through routed messages, ``9qK8…/README.md:88-113``)."""
        self._outbox.append({
            "Target": target,
            "From": self.id,
            "Tags": [{"name": k, "value": str(v)}
                     for k, v in (tags or {}).items()],
            "Data": data,
        })

    # -- handler registry (aos ``Handlers.add`` analog) --------------------

    def add_handler(self, action: str, fn: Callable[[dict, dict], str]) -> None:
        self.handlers[action] = fn

    def _register_defaults(self) -> None:
        def tags(msg):
            return {t["name"]: t["value"] for t in msg.get("Tags", [])}

        self.add_handler("Info", lambda m, e: self._t().info())
        self.add_handler("TestJWT", lambda m, e: str(self._t().testJWT()))
        self.add_handler("GenerateSecretKey", lambda m, e: self._t().generateSecretKey(
            tags(m).get("Token", "a.b"), tags(m).get("JWKS", "")) or "")
        self.add_handler("GeneratePublicKey", lambda m, e: self._t().generatePublicKey())
        self.add_handler("EncryptInteger", lambda m, e: self._t().encryptInteger(
            int(tags(m).get("Value", m.get("Data", "0")))))
        self.add_handler("DecryptInteger", lambda m, e: str(self._t().decryptInteger(
            m.get("Data", ""), "", tags(m).get("Token", "a.b"), "")))
        self.add_handler("EncryptASCIIString", lambda m, e: self._t().encryptASCIIString(
            m.get("Data", "")))
        self.add_handler("DecryptASCIIString", lambda m, e: self._t().decryptASCIIString(
            m.get("Data", ""), int(tags(m)["Length"]), "", tags(m).get("Token", "a.b"), "") or "")
        self.add_handler("AddCiphertexts", lambda m, e: self._t().addCiphertexts(
            *json.loads(m.get("Data", "[]"))))
        self.add_handler("SubtractCiphertexts", lambda m, e: self._t().subtractCiphertexts(
            *json.loads(m.get("Data", "[]"))))
        self.add_handler("Eval", self._handle_eval)
        self.add_handler("Send", self._handle_send)

    # -- the Lua environment (aos _G analog, persistent across messages) ----

    def _lua_globals(self) -> lua.LuaTable:
        if self._lua_G is not None:
            return self._lua_G
        bridge = _tfhe_bridge(self._t())
        llama_t, llama_backend_t = self._llama_tables()

        G = lua.make_stdlib(self._prints.append, self._crypto,
                            modules={".tfhe": bridge, "tfhe": bridge,
                                     "llama": llama_backend_t})
        G.set("Tfhe", bridge)
        G.set("Llama", llama_t)

        ao = lua.LuaTable({"id": self.id})

        def ao_send(m):
            if not isinstance(m, lua.LuaTable):
                raise lua.LuaError("ao.send expects a message table")
            tags = {}
            t = m.get("Tags")
            if isinstance(t, lua.LuaTable):
                for i in range(t.length()):
                    entry = t.get(i + 1)
                    if isinstance(entry, lua.LuaTable):
                        tags[entry.get("name")] = entry.get("value")
                for k, v in t.hash.items():
                    if not isinstance(k, int):
                        tags[k] = v
            for k, v in m.hash.items():
                if k not in ("Target", "Data", "Tags") and isinstance(k, str) \
                        and isinstance(v, (str, int, float)):
                    tags[k] = v
            self.send(m.get("Target") or "", tags,
                      lua.lua_tostring(m.get("Data") or ""))
            return None

        ao.set("send", ao_send)
        G.set("ao", ao)

        handlers = lua.LuaTable()

        def handlers_add(name, pattern, fn=None):
            if fn is None:        # Handlers.add(name, fn): match on Action==name
                fn = pattern
                pattern = name
            self._lua_handlers = [h for h in self._lua_handlers
                                  if h[0] != name]
            self._lua_handlers.append((name, pattern, fn))
            return None

        def handlers_remove(name):
            self._lua_handlers = [h for h in self._lua_handlers
                                  if h[0] != name]
            return None

        def has_matching_tag(name, value):
            def matcher(msg_t):
                tags = msg_t.get("Tags") if isinstance(msg_t, lua.LuaTable) else None
                if isinstance(tags, lua.LuaTable):
                    for i in range(tags.length()):
                        e = tags.get(i + 1)
                        if isinstance(e, lua.LuaTable) and \
                                e.get("name") == name and e.get("value") == value:
                            return True
                return False
            return matcher

        handlers.set("add", handlers_add)
        handlers.set("remove", handlers_remove)
        handlers.set("utils", lua.LuaTable({"hasMatchingTag": has_matching_tag}))
        G.set("Handlers", handlers)

        # ``Process`` global: identity + creation env + module loading, the
        # usage surface the published module's README documents
        # (``Process.load(id)``, ``Process.env.JWT_TOKEN``).  ``load``
        # resolves the two published TFHE module ids (and the short names) to
        # the Tfhe bridge.
        proc_t = lua.LuaTable({"Id": self.id,
                               "env": lua._to_lua(self.process_env)})

        def process_load(module_id):
            known = {
                "9qK8gsMKL2ZVOyP7DlPnEXKh_li2Fl_6liydOjprnPQ",
                "WcCLnB2zVpgkIJd5OECIJTbRXGjzbbPbyxrZemThpuI",
                "tfhe", ".tfhe",
            }
            if module_id in known:
                return bridge
            raise lua.LuaError(f"Process.load: unknown module {module_id!r}")

        proc_t.set("load", process_load)
        G.set("Process", proc_t)
        self._lua_G = G
        return G

    def _llama_tables(self) -> tuple[lua.LuaTable, lua.LuaTable]:
        """The AO-Llama surface: (``Llama`` shim table, ``require("llama")``
        backend table).

        The reference boots ``Llama = <shim>; Llama.backend =
        require("llama")`` into the same process as ``Tfhe`` (SURVEY.md
        §3.1).  The backend table carries the ao-llama C binding names
        (``load / set_prompt / add / run / next / stop``); the shim mirrors
        the Lua module of the shipped wasm (``Llama.load/setPrompt/add/run/
        next/stop/info`` and the ``onLog``/``onProgress``/``logLevels``
        plumbing).  The engine behind it is :mod:`.models.ao_llama`, made
        lazily on the process's device."""
        llama_t = lua.LuaTable()
        levels = lua.LuaTable({2: "error", 3: "warn", 4: "info", 5: "debug"})
        llama_t.set("logLevels", levels)
        llama_t.set("logLevel", 5)
        llama_t.set("logToStderr", False)   # sandbox has no stderr handle
        llama_t.set("log", lua.LuaTable())

        def llama_on_log(level, s):
            # the shim's Llama.onLog: store under log[levelname] when
            # level <= Llama.logLevel (reference shim, wasm strings)
            lvl = llama_t.get("logLevel")
            if not isinstance(lvl, (int, float)) or level > lvl:
                return
            name = levels.get(level) or str(level)
            log = llama_t.get("log")
            bucket = log.get(name)
            if not isinstance(bucket, lua.LuaTable):
                bucket = lua.LuaTable()
                log.set(name, bucket)
            bucket.set(bucket.length() + 1, lua.lua_tostring(s))

        def llama_backend():
            if self._llama_backend is None:
                from .models.ao_llama import LlamaBackend
                self._llama_backend = LlamaBackend(
                    store=self.model_store, vfs=self.vfs,
                    on_log=llama_on_log, device=self.device)
            return self._llama_backend

        backend_t = lua.LuaTable()
        for bname in ("load", "set_prompt", "add", "run", "next", "stop"):
            def bwrap(m=bname):
                def call(*args):
                    return getattr(llama_backend(), m)(*args)
                return call
            backend_t.set(bname, bwrap())

        llama_t.set("backend", backend_t)
        llama_t.set("info", lambda: (
            "A decentralized LLM inference engine, built on top of "
            "llama.cpp."))
        llama_t.set("load", lambda item_id: backend_t.get("load")(item_id))
        llama_t.set("setPrompt", lambda p: backend_t.get("set_prompt")(p))
        llama_t.set("add", lambda s: backend_t.get("add")(s))
        llama_t.set("run", lambda n: backend_t.get("run")(n))
        llama_t.set("next", lambda: backend_t.get("next")())
        llama_t.set("stop", lambda: backend_t.get("stop")())
        llama_t.set("onLog", lambda level, s: llama_on_log(level, s))
        llama_t.set("onProgress", lambda s: None)
        return llama_t, backend_t

    def _msg_to_lua(self, msg: dict) -> lua.LuaTable:
        t = lua._to_lua(msg)
        # aos convenience: flattened tag access (msg.Action etc.)
        for tag in msg.get("Tags", []):
            if isinstance(tag, dict) and tag.get("name") not in t.hash:
                t.set(tag["name"], tag.get("value"))
        return t

    def _handle_eval(self, msg: dict, env: dict) -> str:
        """aos ``_eval``: run message Data as a Lua chunk against the
        persistent process globals; output = prints + the returned value."""
        G = self._lua_globals()
        src = msg.get("Data", "")
        try:
            # aos REPL convention: try `return <expr>` first, then run the
            # chunk — with a trailing expression statement promoted to a
            # return so interactive sequences yield their last value.
            try:
                block = lua.parse("return " + src)
            except lua.LuaError:
                block = lua.parse(src)
                stmts = block[1]
                if stmts and stmts[-1][0] == "exprstat":
                    stmts[-1] = ("return", [stmts[-1][1]])
            interp = lua.Interpreter(G)
            G._interp = interp       # hidden slot — not a Lua-visible global
            ret = []
            try:
                interp.exec_block(block, lua.Env())
            except lua._Return as r:
                ret = r.values
        except lua.LuaError as exc:
            raise EvalError(str(exc)) from exc
        parts = list(self._prints)
        if ret and ret[0] is not None:
            parts.append(lua.lua_tostring(ret[0]))
        return "\n".join(parts)

    def _dispatch_lua_handlers(self, msg: dict, env: dict) -> str | None:
        """aos Handlers evaluation: first registered handler whose matcher
        accepts the message runs; returns its printed output (or None if no
        matcher fired)."""
        if not self._lua_handlers:
            return None
        G = self._lua_globals()
        interp = lua.Interpreter(G)
        G._interp = interp           # hidden slot — not a Lua-visible global
        msg_t = self._msg_to_lua(msg)
        tags = {t["name"]: t["value"] for t in msg.get("Tags", [])}
        for name, pattern, fn in list(self._lua_handlers):
            matched = False
            if isinstance(pattern, str):
                matched = tags.get("Action") == pattern
            elif isinstance(pattern, lua.LuaTable):
                matched = all(tags.get(k) == v for k, v in pattern.hash.items())
            else:
                out = interp.call(pattern, [msg_t])
                matched = bool(out) and out[0] not in (None, False)
            if not matched:
                continue
            ret = interp.call(fn, [msg_t])
            parts = list(self._prints)
            if ret and ret[0] is not None:
                parts.append(lua.lua_tostring(ret[0]))
            return "\n".join(parts)
        return None

    def _handle_send(self, msg: dict, env: dict) -> str:
        """Forward Data to another process (tag Target), ao.send-style."""
        tags = {t["name"]: t["value"] for t in msg.get("Tags", [])}
        fwd = {k: v for k, v in tags.items()
               if k not in ("Action", "Target", "Forward-Action")}
        fwd["Action"] = tags.get("Forward-Action", "Eval")
        self.send(tags.get("Target", ""), fwd, msg.get("Data", ""))
        return "OK"

    def _t(self) -> Tfhe:
        if self.tfhe is None:
            raise RuntimeError("process not initialized (no message seen yet)")
        return self.tfhe

    # -- the wasm-export-shaped entry point --------------------------------

    def handle(self, msg_json: str, env_json: str) -> str:
        """``handle(msgJSON, envJSON) -> responseJSON`` (tests/process.js:4755).

        Response shape mirrors ao-loader results:
        ``{"Output": {"data": {"output": ...}}, "Messages": [], "Error": ...}``.
        """
        msg = json.loads(msg_json)
        env = json.loads(env_json)
        if self.tfhe is None:
            seed = _seed_from_env(env, msg)
            self.tfhe = Tfhe(params=self._params, seed=seed, device=self.device)
            self._crypto.seed(seed)       # aos .crypto chain-coordinate seed
        self.log.append((msg_json, env_json))

        tags = {t["name"]: t["value"] for t in msg.get("Tags", [])}
        action = tags.get("Action", "")
        self._outbox = []
        self._prints.clear()
        try:
            handler = self.handlers.get(action)
            if handler is not None:
                out = handler(msg, env)
            else:
                out = self._dispatch_lua_handlers(msg, env)
                if out is None:
                    return json.dumps({
                        "Output": {"data": {"output": ""}}, "Messages": [],
                        "Error": f"no handler for Action {action!r}"})
            return json.dumps({"Output": {"data": {"output": out}},
                               "Messages": self._outbox, "Error": None})
        except Exception as exc:  # deterministic error surface, process survives
            # DROP the partially-filled outbox: a handler that crashed must
            # not have its half-completed sends routed as side effects of a
            # failed message.
            return json.dumps({"Output": {"data": {"output": ""}},
                               "Messages": [],
                               "Error": f"{type(exc).__name__}: {exc}"})

    # -- replay / recovery --------------------------------------------------

    def replay(self) -> "Process":
        """Re-derive an identical process from this process's message log.

        Carries EVERY constructor input (creation env, model store, virtual
        FS, device): dropping any of them would make the replica diverge
        from the original wherever a chunk branched on ``Process.env``,
        breaking the determinism contract this method exists for."""
        fresh = Process(params=self._params, process_id=self.id,
                        process_env=self.process_env,
                        model_store=self.model_store, vfs=self.vfs,
                        device=self.device)
        for msg_json, env_json in self.log:
            fresh.handle(msg_json, env_json)
        return fresh

    @classmethod
    def from_log(cls, log: list[tuple[str, str]],
                 params: GateBootstrappingParams | None = None,
                 device=None) -> "Process":
        p = cls(params=params, device=device)
        for msg_json, env_json in log:
            p.handle(msg_json, env_json)
        return p


class Router:
    """Host-level message router between processes (the AO network analog).

    Delivers a message to its target process and recursively routes every
    message the handler emitted via :meth:`Process.send`, breadth-first,
    up to ``max_hops`` deliveries — deterministic fan-out, no network.
    """

    def __init__(self, max_hops: int = 64):
        self.processes: dict[str, Process] = {}
        self.max_hops = max_hops

    def register(self, process: Process) -> None:
        if not process.id:
            raise ValueError("process needs an id to be routable")
        self.processes[process.id] = process

    def push(self, target: str, msg: dict, env: dict | None = None) -> list[dict]:
        """Deliver msg to target; route produced messages. Returns the
        ordered list of handle() responses (parsed)."""
        env = env or {"Process": {"Id": target, "Owner": "ROUTER",
                                  "Module": "eoc-tfhe-tpu"}}
        queue = [(target, msg)]
        responses = []
        hops = 0
        while queue:
            if hops >= self.max_hops:
                raise RuntimeError(f"router exceeded {self.max_hops} hops")
            hops += 1
            tgt, m = queue.pop(0)
            proc = self.processes.get(tgt)
            if proc is None:
                responses.append({"Error": f"no process {tgt!r}", "Messages": []})
                continue
            penv = {"Process": {"Id": tgt, "Owner": env["Process"].get("Owner", ""),
                                "Module": env["Process"].get("Module", "")}}
            resp = json.loads(proc.handle(json.dumps(m), json.dumps(penv)))
            responses.append(resp)
            for out in resp.get("Messages", []):
                nm = {"Tags": out.get("Tags", []), "Data": out.get("Data", ""),
                      "From": out.get("From", tgt),
                      "Block-Height": m.get("Block-Height", 0)}
                queue.append((out.get("Target", ""), nm))
        return responses
