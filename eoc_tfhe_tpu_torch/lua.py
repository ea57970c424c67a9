"""Minimal Lua 5.3-subset interpreter for the aos ``Eval`` handler.

A copy of ``eoc_tfhe_tpu/lua.py``.  It is pure Python with no framework in
it; the port carries its own copy because it imports nothing of the JAX
package.  Its code is the reference's, statement for statement
(``tests/test_torch_process.py`` holds the two syntax trees equal with the
docstrings removed); only docstrings and comments are reworded.

The reference's AO runtime evaluates Lua programs sent as message Data (aos
``_eval``: ``load(expr, 'aos', 't', _G)``); its integration tests are Lua
chunks using ``local``, ``require(".tfhe")``, method calls, ``#s``,
``tostring`` and ``return``.  This module is a small tree-walking Lua
interpreter:

  * statements: ``local``, assignment, calls, ``if/elseif/else``, numeric
    and generic ``for``, ``while``, ``repeat``, ``function`` (incl. local
    and method sugar), ``return``, ``break``, ``do`` blocks;
  * expressions: full operator set (``and or not  == ~= < <= > >=  ..
    + - * / // % ^  # -``), tables, closures, varargs-free multiple
    assignment, method calls (``a:b(...)`` and ``a.b(...)``), indexing;
  * sandboxed by construction: the global environment contains only the
    tables the host installs (no Python attribute access: host objects are
    exposed as tables of explicitly bound closures).

It is an interpreter for capability parity, not speed: Eval programs are
orchestration glue; all heavy work happens inside the TFHE calls they make.
"""

from __future__ import annotations

import json as _json
import re


class LuaError(Exception):
    pass


# ---------------------------------------------------------------------------
# Values
# ---------------------------------------------------------------------------

class LuaTable:
    """A Lua table: hash part + 1-based array behavior for ipairs/#."""

    #: ``_interp`` is a PYTHON-side slot, invisible and unassignable from
    #: sandboxed Lua: the interpreter reference used by the stdlib memory
    #: rail must not live as an ordinary Lua global, or a chunk could
    #: ``__interp__ = nil`` its way out of the allocation limits.
    __slots__ = ("hash", "_interp")

    def __init__(self, items=None):
        self.hash = dict(items or {})
        self._interp = None

    def get(self, k):
        if isinstance(k, float) and k.is_integer():
            k = int(k)
        return self.hash.get(k)

    def set(self, k, v):
        if k is None:
            raise LuaError("table index is nil")
        if isinstance(k, float) and k.is_integer():
            k = int(k)
        if v is None:
            self.hash.pop(k, None)
        else:
            self.hash[k] = v

    def length(self):
        n = 0
        while (n + 1) in self.hash:
            n += 1
        return n

    @classmethod
    def from_list(cls, values):
        return cls({i + 1: v for i, v in enumerate(values)})


class LuaFunction:
    __slots__ = ("params", "body", "env", "name")

    def __init__(self, params, body, env, name="?"):
        self.params, self.body, self.env, self.name = params, body, env, name


def lua_tostring(v) -> str:
    if v is None:
        return "nil"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v.is_integer() and abs(v) < 1e16:
            return f"{v:.1f}"
        return repr(v)
    if isinstance(v, str):
        return v
    if isinstance(v, LuaTable):
        return f"table: 0x{id(v):08x}"
    if isinstance(v, LuaFunction) or callable(v):
        return f"function: 0x{id(v):08x}"
    return str(v)


def _truthy(v) -> bool:
    return v is not None and v is not False


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_KEYWORDS = {"and", "break", "do", "else", "elseif", "end", "false", "for",
             "function", "goto", "if", "in", "local", "nil", "not", "or",
             "repeat", "return", "then", "true", "until", "while"}

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--\[\[.*?\]\]|--[^\n]*)
  | (?P<number>0[xX][0-9a-fA-F]+|\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_]\w*)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*'|\[\[.*?\]\])
  | (?P<op>\.\.\.|\.\.|==|~=|<=|>=|//|::|[-+*/%^#<>=(){}\[\];:,.])
""", re.VERBOSE | re.DOTALL)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "a": "\a", "b": "\b",
            "f": "\f", "v": "\v", "\\": "\\", '"': '"', "'": "'", "\n": "\n"}


def _unquote(s: str) -> str:
    if s.startswith("[["):
        return s[2:-2]
    body = s[1:-1]
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            if nxt.isdigit():
                j = i + 1
                while j < len(body) and j < i + 4 and body[j].isdigit():
                    j += 1
                out.append(chr(int(body[i + 1:j])))
                i = j
                continue
            out.append(_ESCAPES.get(nxt, nxt))
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def tokenize(src: str):
    toks, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise LuaError(f"lex error at {src[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind in ("ws", "comment"):
            continue
        if kind == "number":
            if text.lower().startswith("0x"):
                toks.append(("number", int(text, 16)))
            elif any(c in text for c in ".eE") and not text.lower().startswith("0x"):
                toks.append(("number", float(text)))
            else:
                toks.append(("number", int(text)))
        elif kind == "name":
            toks.append(("kw" if text in _KEYWORDS else "name", text))
        elif kind == "string":
            toks.append(("string", _unquote(text)))
        else:
            toks.append(("op", text))
    toks.append(("eof", None))
    return toks


# ---------------------------------------------------------------------------
# Parser -> tuple AST
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, val=None):
        k, v = self.peek()
        if k == kind and (val is None or v == val):
            return self.next()
        return None

    def expect(self, kind, val=None):
        t = self.accept(kind, val)
        if t is None:
            raise LuaError(f"expected {val or kind}, got {self.peek()!r}")
        return t

    # -- statements --
    def block(self, terminators=("eof",)):
        stmts = []
        while True:
            k, v = self.peek()
            if k == "eof" or (k == "kw" and v in terminators):
                return ("block", stmts)
            if k == "op" and v == ";":
                self.next()
                continue
            if k == "kw" and v == "return":
                self.next()
                exprs = []
                k2, v2 = self.peek()
                if not (k2 == "eof" or (k2 == "kw" and v2 in terminators)
                        or (k2 == "op" and v2 == ";")):
                    exprs = self.exprlist()
                self.accept("op", ";")
                stmts.append(("return", exprs))
                return ("block", stmts)
            stmts.append(self.statement())

    def statement(self):
        k, v = self.peek()
        if k == "kw":
            if v == "local":
                self.next()
                if self.accept("kw", "function"):
                    name = self.expect("name")[1]
                    fn = self.funcbody(name)
                    return ("local", [name], [fn])
                names = [self.expect("name")[1]]
                while self.accept("op", ","):
                    names.append(self.expect("name")[1])
                exprs = []
                if self.accept("op", "="):
                    exprs = self.exprlist()
                return ("local", names, exprs)
            if v == "if":
                self.next()
                arms = []
                cond = self.expr()
                self.expect("kw", "then")
                body = self.block(("elseif", "else", "end"))
                arms.append((cond, body))
                while self.accept("kw", "elseif"):
                    c = self.expr()
                    self.expect("kw", "then")
                    arms.append((c, self.block(("elseif", "else", "end"))))
                els = None
                if self.accept("kw", "else"):
                    els = self.block(("end",))
                self.expect("kw", "end")
                return ("if", arms, els)
            if v == "while":
                self.next()
                cond = self.expr()
                self.expect("kw", "do")
                body = self.block(("end",))
                self.expect("kw", "end")
                return ("while", cond, body)
            if v == "repeat":
                self.next()
                body = self.block(("until",))
                self.expect("kw", "until")
                cond = self.expr()
                return ("repeat", body, cond)
            if v == "for":
                self.next()
                n1 = self.expect("name")[1]
                if self.accept("op", "="):
                    e1 = self.expr()
                    self.expect("op", ",")
                    e2 = self.expr()
                    e3 = ("const", 1)
                    if self.accept("op", ","):
                        e3 = self.expr()
                    self.expect("kw", "do")
                    body = self.block(("end",))
                    self.expect("kw", "end")
                    return ("fornum", n1, e1, e2, e3, body)
                names = [n1]
                while self.accept("op", ","):
                    names.append(self.expect("name")[1])
                self.expect("kw", "in")
                exprs = self.exprlist()
                self.expect("kw", "do")
                body = self.block(("end",))
                self.expect("kw", "end")
                return ("forin", names, exprs, body)
            if v == "function":
                self.next()
                target = ("name", self.expect("name")[1])
                is_method = False
                while True:
                    if self.accept("op", "."):
                        target = ("index", target, ("const", self.expect("name")[1]))
                    elif self.accept("op", ":"):
                        target = ("index", target, ("const", self.expect("name")[1]))
                        is_method = True
                        break
                    else:
                        break
                fn = self.funcbody("method" if is_method else "fn",
                                   implicit_self=is_method)
                return ("assign", [target], [fn])
            if v == "do":
                self.next()
                body = self.block(("end",))
                self.expect("kw", "end")
                return ("do", body)
            if v == "break":
                self.next()
                return ("break",)
        # expression statement or assignment
        e = self.suffixedexp()
        if self.peek() == ("op", "=") or self.peek() == ("op", ","):
            targets = [e]
            while self.accept("op", ","):
                targets.append(self.suffixedexp())
            self.expect("op", "=")
            return ("assign", targets, self.exprlist())
        if e[0] not in ("call", "methodcall"):
            raise LuaError(f"syntax error near {self.peek()!r}")
        return ("exprstat", e)

    def funcbody(self, name, implicit_self=False):
        self.expect("op", "(")
        params = ["self"] if implicit_self else []
        if not self.accept("op", ")"):
            while True:
                k, v = self.next()
                if k != "name":
                    raise LuaError(f"bad parameter {v!r}")
                params.append(v)
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        body = self.block(("end",))
        self.expect("kw", "end")
        return ("function", params, body, name)

    def exprlist(self):
        out = [self.expr()]
        while self.accept("op", ","):
            out.append(self.expr())
        return out

    # -- expressions (precedence climbing) --
    _BINPRI = {"or": 1, "and": 2,
               "<": 3, ">": 3, "<=": 3, ">=": 3, "==": 3, "~=": 3,
               "..": 4, "+": 5, "-": 5, "*": 6, "/": 6, "//": 6, "%": 6,
               "^": 8}

    def expr(self, limit=0):
        k, v = self.peek()
        if (k == "op" and v in ("-", "#")) or (k == "kw" and v == "not"):
            self.next()
            operand = self.expr(7)
            left = ("unop", v, operand)
        else:
            left = self.simpleexp()
        while True:
            k, v = self.peek()
            op = v if (k == "op" or (k == "kw" and v in ("and", "or"))) else None
            pri = self._BINPRI.get(op)
            if pri is None or pri <= limit:
                return left
            self.next()
            right = self.expr(pri if op not in ("..", "^") else pri - 1)
            left = ("binop", op, left, right)

    def simpleexp(self):
        k, v = self.peek()
        if k == "number" or k == "string":
            self.next()
            return ("const", v)
        if k == "kw" and v in ("nil", "true", "false"):
            self.next()
            return ("const", {"nil": None, "true": True, "false": False}[v])
        if k == "kw" and v == "function":
            self.next()
            return self.funcbody("anonymous")
        if k == "op" and v == "{":
            return self.tablector()
        return self.suffixedexp()

    def tablector(self):
        self.expect("op", "{")
        arr, fields = [], []
        while not self.accept("op", "}"):
            k, v = self.peek()
            if k == "name" and self.toks[self.i + 1] == ("op", "="):
                self.next()
                self.next()
                fields.append((("const", v), self.expr()))
            elif k == "op" and v == "[":
                self.next()
                key = self.expr()
                self.expect("op", "]")
                self.expect("op", "=")
                fields.append((key, self.expr()))
            else:
                arr.append(self.expr())
            if not (self.accept("op", ",") or self.accept("op", ";")):
                self.expect("op", "}")
                break
        return ("table", arr, fields)

    def suffixedexp(self):
        k, v = self.peek()
        if k == "op" and v == "(":
            self.next()
            e = self.expr()
            self.expect("op", ")")
            base = ("paren", e)
        elif k == "name":
            self.next()
            base = ("name", v)
        else:
            raise LuaError(f"unexpected token {v!r}")
        while True:
            k, v = self.peek()
            if k == "op" and v == ".":
                self.next()
                base = ("index", base, ("const", self.expect("name")[1]))
            elif k == "op" and v == "[":
                self.next()
                idx = self.expr()
                self.expect("op", "]")
                base = ("index", base, idx)
            elif k == "op" and v == "(":
                base = ("call", base, self.callargs())
            elif k == "op" and v == ":":
                self.next()
                meth = self.expect("name")[1]
                base = ("methodcall", base, meth, self.callargs())
            elif k == "string":
                self.next()
                base = ("call", base, [("const", v)])
            elif k == "op" and v == "{":
                base = ("call", base, [self.tablector()])
            else:
                return base

    def callargs(self):
        self.expect("op", "(")
        if self.accept("op", ")"):
            return []
        args = self.exprlist()
        self.expect("op", ")")
        return args


def parse(src: str):
    p = _Parser(tokenize(src))
    blk = p.block()
    if p.peek()[0] != "eof":
        raise LuaError(f"trailing input at {p.peek()!r}")
    return blk


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

class _Return(Exception):
    def __init__(self, values):
        self.values = values


class _Break(Exception):
    pass


class Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent

    def get(self, name):
        e = self
        while e is not None:
            if name in e.vars:
                return e.vars[name]
            e = e.parent
        return None

    def lookup(self, name):
        """(found, value) — distinguishes a local declared nil from an
        undeclared name (``local x = nil`` must shadow a global
        ``x``, not fall through to it)."""
        e = self
        while e is not None:
            if name in e.vars:
                return True, e.vars[name]
            e = e.parent
        return False, None

    def set_existing(self, name, value):
        e = self
        while e is not None:
            if name in e.vars:
                e.vars[name] = value
                return True
            e = e.parent
        return False

    def declare(self, name, value):
        self.vars[name] = value


_MAX_STEPS = 2_000_000
#: Memory rail: the reference wasm runs under an AO
#: ``Memory-Limit: 1-gb`` tag (set by its module publishing script);
#: this sandbox caps any single string result and the cumulative string
#: bytes allocated per interpreter, so ``string.rep(s, 2^40)`` or repeated
#: ``s = s .. s`` doubling cannot OOM the host within the step budget.
_MAX_STRING = 8 * 2 ** 20
_MAX_STR_ALLOC = 256 * 2 ** 20


class Interpreter:
    def __init__(self, globals_table: LuaTable):
        self.globals = globals_table
        self.steps = 0
        self.str_alloc = 0

    def charge_str(self, nchars: int) -> None:
        """Account a string allocation against the memory rail."""
        if nchars > _MAX_STRING:
            raise LuaError("memory limit exceeded (string too long)")
        self.str_alloc += nchars
        if self.str_alloc > _MAX_STR_ALLOC:
            raise LuaError("memory limit exceeded")

    # value helpers ---------------------------------------------------------
    def _tonum(self, v, what="arithmetic"):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return v
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                try:
                    return float(v)
                except ValueError:
                    pass
        raise LuaError(f"attempt to perform {what} on a "
                       f"{self._typename(v)} value")

    @staticmethod
    def _typename(v):
        if v is None:
            return "nil"
        if isinstance(v, bool):
            return "boolean"
        if isinstance(v, (int, float)):
            return "number"
        if isinstance(v, str):
            return "string"
        if isinstance(v, LuaTable):
            return "table"
        return "function"

    def call(self, fn, args):
        self.steps += 1
        if self.steps > _MAX_STEPS:
            raise LuaError("instruction budget exceeded")
        if isinstance(fn, LuaFunction):
            env = Env(fn.env)
            for i, p in enumerate(fn.params):
                env.declare(p, args[i] if i < len(args) else None)
            try:
                self.exec_block(fn.body, env)
            except _Return as r:
                return r.values
            return []
        if callable(fn):
            out = fn(*args)
            if isinstance(out, tuple):
                return list(out)
            return [] if out is None else [out]
        raise LuaError(f"attempt to call a {self._typename(fn)} value")

    # statements ------------------------------------------------------------
    def exec_block(self, block, env):
        assert block[0] == "block"
        for stmt in block[1]:
            self.exec_stmt(stmt, env)

    def exec_stmt(self, stmt, env):
        self.steps += 1
        if self.steps > _MAX_STEPS:
            raise LuaError("instruction budget exceeded")
        op = stmt[0]
        if op == "local":
            _, names, exprs = stmt
            vals = self.eval_list(exprs, env, want=len(names))
            for n, v in zip(names, vals):
                env.declare(n, v)
        elif op == "assign":
            _, targets, exprs = stmt
            vals = self.eval_list(exprs, env, want=len(targets))
            for t, v in zip(targets, vals):
                self.assign(t, v, env)
        elif op == "exprstat":
            self.eval(stmt[1], env)
        elif op == "if":
            _, arms, els = stmt
            for cond, body in arms:
                if _truthy(self.eval1(cond, env)):
                    self.exec_block(body, Env(env))
                    return
            if els is not None:
                self.exec_block(els, Env(env))
        elif op == "while":
            _, cond, body = stmt
            while _truthy(self.eval1(cond, env)):
                try:
                    self.exec_block(body, Env(env))
                except _Break:
                    break
        elif op == "repeat":
            _, body, cond = stmt
            while True:
                inner = Env(env)
                try:
                    self.exec_block(body, inner)
                except _Break:
                    break
                if _truthy(self.eval1(cond, inner)):
                    break
        elif op == "fornum":
            _, name, e1, e2, e3, body = stmt
            i = self._tonum(self.eval1(e1, env))
            stop = self._tonum(self.eval1(e2, env))
            step = self._tonum(self.eval1(e3, env))
            if step == 0:
                raise LuaError("'for' step is zero")
            while (step > 0 and i <= stop) or (step < 0 and i >= stop):
                inner = Env(env)
                inner.declare(name, i)
                try:
                    self.exec_block(body, inner)
                except _Break:
                    break
                i += step
        elif op == "forin":
            _, names, exprs, body = stmt
            vals = self.eval_list(exprs, env, want=3)
            iter_fn, state, control = vals[0], vals[1], vals[2]
            while True:
                rets = self.call(iter_fn, [state, control])
                if not rets or rets[0] is None:
                    break
                control = rets[0]
                inner = Env(env)
                for i, n in enumerate(names):
                    inner.declare(n, rets[i] if i < len(rets) else None)
                try:
                    self.exec_block(body, inner)
                except _Break:
                    break
        elif op == "do":
            self.exec_block(stmt[1], Env(env))
        elif op == "break":
            raise _Break()
        elif op == "return":
            vals = []
            for i, e in enumerate(stmt[1]):
                v = self.eval(e, env)
                if i == len(stmt[1]) - 1 and isinstance(v, list):
                    vals.extend(v)
                else:
                    vals.append(v[0] if isinstance(v, list) else v)
            raise _Return(vals)
        else:
            raise LuaError(f"bad statement {op}")

    def assign(self, target, value, env):
        if target[0] == "name":
            name = target[1]
            if not env.set_existing(name, value):
                self.globals.set(name, value)
        elif target[0] == "index":
            obj = self.eval1(target[1], env)
            key = self.eval1(target[2], env)
            if not isinstance(obj, LuaTable):
                raise LuaError(f"attempt to index a {self._typename(obj)} value")
            obj.set(key, value)
        else:
            raise LuaError("cannot assign to this expression")

    # expressions -----------------------------------------------------------
    def eval_list(self, exprs, env, want):
        vals = []
        for i, e in enumerate(exprs):
            v = self.eval(e, env)
            if i == len(exprs) - 1 and isinstance(v, list):
                vals.extend(v)
            else:
                vals.append(v[0] if isinstance(v, list) else v)
        while len(vals) < want:
            vals.append(None)
        return vals

    def eval1(self, e, env):
        v = self.eval(e, env)
        if isinstance(v, list):
            return v[0] if v else None
        return v

    def eval(self, e, env):
        self.steps += 1
        if self.steps > _MAX_STEPS:
            raise LuaError("instruction budget exceeded")
        op = e[0]
        if op == "const":
            return e[1]
        if op == "name":
            found, v = env.lookup(e[1])
            if found:
                return v
            return self.globals.get(e[1])
        if op == "paren":
            return self.eval1(e[1], env)
        if op == "index":
            obj = self.eval1(e[1], env)
            key = self.eval1(e[2], env)
            if isinstance(obj, LuaTable):
                return obj.get(key)
            if isinstance(obj, str):
                strlib = self.globals.get("string")
                if isinstance(strlib, LuaTable):
                    return strlib.get(key)
            raise LuaError(f"attempt to index a {self._typename(obj)} value")
        if op == "call":
            fn = self.eval1(e[1], env)
            args = self.eval_list(e[2], env, want=0)
            return self.call(fn, args)
        if op == "methodcall":
            obj = self.eval1(e[1], env)
            if isinstance(obj, LuaTable):
                fn = obj.get(e[2])
            elif isinstance(obj, str):
                strlib = self.globals.get("string")
                fn = strlib.get(e[2]) if isinstance(strlib, LuaTable) else None
            else:
                raise LuaError(f"attempt to index a {self._typename(obj)} value")
            args = [obj] + self.eval_list(e[3], env, want=0)
            return self.call(fn, args)
        if op == "function":
            _, params, body, name = e
            return LuaFunction(params, body, env, name)
        if op == "table":
            _, arr, fields = e
            t = LuaTable()
            idx = 1
            for i, a in enumerate(arr):
                v = self.eval(a, env)
                if i == len(arr) - 1 and isinstance(v, list):
                    for vv in v:
                        t.set(idx, vv)
                        idx += 1
                else:
                    t.set(idx, v[0] if isinstance(v, list) else v)
                    idx += 1
            for k, v in fields:
                t.set(self.eval1(k, env), self.eval1(v, env))
            return t
        if op == "unop":
            o = e[1]
            if o == "not":
                return not _truthy(self.eval1(e[2], env))
            v = self.eval1(e[2], env)
            if o == "-":
                return -self._tonum(v)
            if o == "#":
                if isinstance(v, str):
                    return len(v)
                if isinstance(v, LuaTable):
                    return v.length()
                raise LuaError("attempt to get length of a "
                               f"{self._typename(v)} value")
        if op == "binop":
            o = e[1]
            if o == "and":
                left = self.eval1(e[2], env)
                return self.eval1(e[3], env) if _truthy(left) else left
            if o == "or":
                left = self.eval1(e[2], env)
                return left if _truthy(left) else self.eval1(e[3], env)
            a = self.eval1(e[2], env)
            b = self.eval1(e[3], env)
            if o == "..":
                for x in (a, b):
                    if not isinstance(x, (str, int, float)) or isinstance(x, bool):
                        raise LuaError("attempt to concatenate a "
                                       f"{self._typename(x)} value")
                sa, sb = lua_tostring(a), lua_tostring(b)
                self.charge_str(len(sa) + len(sb))
                return sa + sb
            if o == "==":
                return self._eq(a, b)
            if o == "~=":
                return not self._eq(a, b)
            if o in ("<", "<=", ">", ">="):
                if isinstance(a, str) and isinstance(b, str):
                    pass
                else:
                    a, b = self._tonum(v=a, what="comparison"), \
                        self._tonum(v=b, what="comparison")
                return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b}[o]
            a = self._tonum(a)
            b = self._tonum(b)
            if o == "+":
                return a + b
            if o == "-":
                return a - b
            if o == "*":
                return a * b
            if o == "/":
                return a / b
            if o == "//":
                return a // b
            if o == "%":
                return a - (a // b) * b
            if o == "^":
                return float(a) ** float(b)
        raise LuaError(f"bad expression {op}")

    @staticmethod
    def _eq(a, b):
        if isinstance(a, bool) or isinstance(b, bool):
            return a is b
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return a == b
        if type(a) is type(b):
            return a == b if isinstance(a, str) else a is b
        return False


# ---------------------------------------------------------------------------
# Standard library (the aos-relevant subset)
# ---------------------------------------------------------------------------

def _fmt_lua(spec, args, charge=None):
    """string.format with Lua %d/%s/%f/%x/%g/%q/%% subset.

    ``charge``: optional allocation-rail callback, called with each
    formatted piece's length as it is produced (incremental, so the
    cumulative-allocation rail counts the result once), plus a running
    single-string cap on the joined total — so a format string with many
    specifiers trips the memory rail while building, before a huge result
    (or its piece list) materializes."""
    total = 0

    def _acct(piece):
        nonlocal total
        total += len(piece)
        if total > _MAX_STRING:
            raise LuaError("memory limit exceeded (string too long)")
        if charge is not None:
            charge(len(piece))
        return piece

    out = []
    i = 0
    ai = 0
    while i < len(spec):
        c = spec[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        j = i + 1
        while j < len(spec) and spec[j] in "-+ #0123456789.":
            j += 1
        for run in re.findall(r"\d+", spec[i + 1:j]):
            if int(run) > _MAX_STRING:   # width/precision memory rail
                raise LuaError("memory limit exceeded (format width)")
        if j >= len(spec):
            # trailing '%' with no conversion char — Lua-level error, not a
            # host IndexError
            raise LuaError("invalid format string to 'format'")
        conv = spec[j]
        if conv == "%":
            out.append(_acct("%"))
            i = j + 1
            continue
        if ai >= len(args):
            raise LuaError(
                f"bad argument #{ai + 2} to 'format' (no value)")
        arg = args[ai]
        ai += 1
        pyspec = "%" + spec[i + 1:j] + (conv if conv != "q" else "s")
        if conv in "dioxX":
            arg = int(arg)
        elif conv in "eEfgG":
            arg = float(arg)
        elif conv == "q":
            arg = _json.dumps(lua_tostring(arg))
        else:
            arg = lua_tostring(arg)
        out.append(_acct(pyspec % arg))
        i = j + 1
    return "".join(out)


def _sub(s, i, j=-1):
    i, j = int(i), int(j)
    n = len(s)
    if i < 0:
        i = max(n + i + 1, 1)
    elif i == 0:
        i = 1
    if j < 0:
        j = n + j + 1
    return s[i - 1:j]


class Crypto:
    """Deterministic ``.crypto``-analog RNG (the aos chance.js pattern:
    seeded from chain coordinates — wasm string
    ``chance.seed(tonumber(msg['Block-Height'] .. stringToSeed(...)))``).

    A 64-bit SplitMix-style generator: identical seed -> identical stream,
    which is what makes process replay reproduce random choices.
    """

    def __init__(self, seed: int = 0):
        self.state = seed & 0xFFFFFFFFFFFFFFFF

    def seed(self, s):
        self.state = int(s) & 0xFFFFFFFFFFFFFFFF
        return None

    def _next(self) -> int:
        self.state = (self.state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = self.state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return z ^ (z >> 31)

    def random(self, m=None, n=None):
        if m is None:
            return self._next() / 2.0 ** 64
        if n is None:
            m, n = 1, m
        return int(m) + self._next() % (int(n) - int(m) + 1)

    def integer(self, mn, mx):
        return self.random(mn, mx)


def make_stdlib(print_sink, crypto: Crypto | None = None,
                modules: dict | None = None) -> LuaTable:
    """Build the sandboxed global table: base functions + string/table/math
    + json + crypto + a ``require`` over the host-registered module map."""
    G = LuaTable()
    modules = dict(modules or {})
    _dcrypto = crypto if crypto is not None else Crypto(0)

    def lua_print(*args):
        print_sink("\t".join(lua_tostring(a) for a in args))

    def tonumber(v, base=None):
        if base is not None:
            try:
                return int(str(v), int(base))
            except ValueError:
                return None
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return v
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                try:
                    return float(v)
                except ValueError:
                    return None
        return None

    def _pairs_iter(t, control):
        keys = list(t.hash.keys())
        if control is None:
            idx = 0
        else:
            idx = keys.index(control) + 1 if control in keys else len(keys)
        if idx >= len(keys):
            return None
        k = keys[idx]
        return (k, t.hash[k])

    def lua_pairs(t):
        return (lambda s, c: _pairs_iter(t, c), t, None)

    def _inext(t, i):
        v = t.get(int(i) + 1)
        if v is None:
            return None
        return (int(i) + 1, v)

    def lua_ipairs(t):
        return (_inext, t, 0)

    def lua_require(name):
        mod = modules.get(name)
        if mod is None:
            raise LuaError(f"module '{name}' not found")
        return mod

    def lua_error(msg, level=None):
        raise LuaError(lua_tostring(msg))

    def lua_assert(v, msg=None):
        if not _truthy(v):
            raise LuaError(lua_tostring(msg) if msg is not None
                           else "assertion failed!")
        return v

    def _charge(nchars):
        interp = G._interp
        if interp is not None:
            interp.charge_str(nchars)
        elif nchars > _MAX_STRING:
            raise LuaError("memory limit exceeded (string too long)")

    def lua_pcall(fn, *args):
        interp = G._interp
        try:
            out = interp.call(fn, list(args))
            return tuple([True] + out)
        except LuaError as exc:
            return (False, str(exc))
        except (_Return, _Break):
            raise
        except Exception as exc:  # host-bridge/stdlib failures:
            # real Lua's pcall captures errors raised inside C functions;
            # convert Python exceptions from bound host calls the same way.
            return (False, f"{type(exc).__name__}: {exc}")

    G.set("print", lua_print)
    G.set("tostring", lua_tostring)
    G.set("tonumber", tonumber)
    G.set("type", lambda v: Interpreter._typename(v))
    G.set("pairs", lua_pairs)
    G.set("ipairs", lua_ipairs)
    G.set("require", lua_require)
    G.set("error", lua_error)
    G.set("assert", lua_assert)
    G.set("pcall", lua_pcall)
    G.set("select", lambda n, *a: len(a) if n == "#" else a[int(n) - 1])
    G.set("unpack", lambda t: tuple(t.get(i + 1) for i in range(t.length())))

    strlib = LuaTable({
        "len": lambda s: len(s),
        "sub": _sub,
        "upper": lambda s: s.upper(),
        "lower": lambda s: s.lower(),
        # charge max(count, chars): even rep('', 2^40) must not build a
        # 2^40-element Python list
        "rep": lambda s, n, sep=None: (
            (_charge(max(int(n), (len(s) + len(sep or "")) * int(n))) or
             (sep or "").join([s] * int(n)))
            if n and int(n) > 0 else ""),
        "reverse": lambda s: s[::-1],
        "byte": _lua_byte,
        "char": lambda *a: "".join(chr(int(x)) for x in a),
        # charge the joined result incrementally, not only per-specifier
        # widths: a format string with many specifiers could otherwise
        # materialize far above _MAX_STRING without hitting either limit
        "format": lambda spec, *a: _fmt_lua(spec, list(a), charge=_charge),
        "find": lambda s, pat, init=1: _lua_find(s, pat, int(init)),
        "gsub": lambda s, pat, repl, n=None: _lua_gsub(s, pat, repl, n),
        "match": lambda s, pat, init=1: _lua_match(s, pat, int(init)),
    })
    G.set("string", strlib)

    import math as _math
    G.set("math", LuaTable({
        "floor": lambda x: int(_math.floor(x)),
        "ceil": lambda x: int(_math.ceil(x)),
        "abs": abs,
        "max": max, "min": min,
        "sqrt": _math.sqrt,
        "huge": _math.inf,
        "pi": _math.pi,
        # one SHARED instance when the host passes none — separate fresh
        # instances would make randomseed a no-op on random
        "random": _dcrypto.random,
        "randomseed": _dcrypto.seed,
    }))

    def t_insert(t, a, b=None):
        if b is None:
            t.set(t.length() + 1, a)
        else:
            pos = int(a)
            for i in range(t.length(), pos - 1, -1):
                t.set(i + 1, t.get(i))
            t.set(pos, b)

    def t_remove(t, pos=None):
        n = t.length()
        if n == 0:
            return None
        pos = n if pos is None else int(pos)
        v = t.get(pos)
        for i in range(pos, n):
            t.set(i, t.get(i + 1))
        t.set(n, None)
        return v

    G.set("table", LuaTable({
        "insert": t_insert,
        "remove": t_remove,
        "concat": lambda t, sep="": (_charge(sum(
            len(lua_tostring(t.get(i + 1))) + len(sep or "")
            for i in range(t.length()))) or (sep or "").join(
            lua_tostring(t.get(i + 1)) for i in range(t.length()))),
    }))

    def json_encode(v):
        return _json.dumps(_to_py(v))

    def json_decode(s):
        return _to_lua(_json.loads(s))

    jsonlib = LuaTable({"encode": json_encode, "decode": json_decode})
    G.set("json", jsonlib)
    modules.setdefault("json", jsonlib)
    if crypto is not None:
        cryptolib = LuaTable({
            "seed": crypto.seed,
            "random": crypto.random,
            "integer": crypto.integer,
        })
        G.set("crypto", cryptolib)
        modules.setdefault(".crypto", cryptolib)
        modules.setdefault(".crypto.init", cryptolib)
    return G


# Lua pattern subset -> Python regex (enough for aos matchers: literals,
# %a %d %s %w %p classes, anchors, captures, + - * ? . [sets]).
_CLASS = {"a": "[A-Za-z]", "A": "[^A-Za-z]", "d": "[0-9]", "D": "[^0-9]",
          "s": r"\s", "S": r"\S", "w": "[A-Za-z0-9]", "W": "[^A-Za-z0-9]",
          "p": r"[\!-/\:-@\[-`\{-~]", "l": "[a-z]", "u": "[A-Z]"}


def _lua_byte(s, i=1):
    """string.byte with Lua index semantics: negative counts from the end
    (-1 = last char), 0 / out-of-range yields no value (the
    old ord(s[i-1]) mapped -1 to the SECOND-to-last char)."""
    i = int(i)
    n = len(s)
    if i < 0:
        i = n + i + 1
    if i < 1 or i > n:
        return None
    return ord(s[i - 1])


def _pat2re(pat: str) -> str:
    # (?s): Lua's '.' matches ANY character including newline
    out, i = ["(?s)"], 0
    while i < len(pat):
        c = pat[i]
        if c == "%":
            i += 1
            if i >= len(pat):
                raise LuaError("malformed pattern (ends with '%')")
            n = pat[i]
            out.append(_CLASS.get(n, re.escape(n)))
        elif c == "-":
            out.append("*?")
        elif c in "().[]^$*+?":
            if c == "(" or c == ")":
                out.append(c)
            elif c == "[":
                j = i + 1
                cls = ["["]
                if j < len(pat) and pat[j] == "^":
                    cls.append("^")
                    j += 1
                while j < len(pat) and pat[j] != "]":
                    if pat[j] == "%":
                        cls.append(_CLASS.get(pat[j + 1], re.escape(pat[j + 1]))
                                   .strip("[]"))
                        j += 2
                    else:
                        cls.append(re.escape(pat[j]))
                        j += 1
                cls.append("]")
                out.append("".join(cls))
                i = j
            elif c in "^$*+?.":
                # Lua anchors only at the pattern edges; elsewhere ^ and $
                # are literals ('a^b' must match literally)
                if c == "^":
                    out.append("^" if i == 0 else re.escape(c))
                elif c == "$":
                    out.append("$" if i == len(pat) - 1 else re.escape(c))
                else:
                    out.append(c)
            else:
                out.append(re.escape(c))
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


def _lua_find(s, pat, init=1):
    m = re.compile(_pat2re(pat)).search(s, init - 1)
    if not m:
        return None
    if m.groups():
        return tuple([m.start() + 1, m.end()] + list(m.groups()))
    return (m.start() + 1, m.end())


def _lua_match(s, pat, init=1):
    m = re.compile(_pat2re(pat)).search(s, init - 1)
    if not m:
        return None
    if m.groups():
        gs = m.groups()
        return gs[0] if len(gs) == 1 else tuple(gs)
    return m.group(0)


def _lua_gsub(s, pat, repl, n=None):
    # Lua count semantics: n <= 0 replaces NOTHING (Python's count=0 means
    # unlimited)
    if n is not None and int(n) <= 0:
        return (s, 0)
    count = 0 if n is None else int(n)
    if not isinstance(repl, str):
        raise LuaError("gsub with function replacement not supported")
    compiled = re.compile(_pat2re(pat))
    # Replacement translation: %% -> literal %, %0 -> whole
    # match, %d -> capture d (the whole match when the pattern has no
    # captures, Lua's convention); backslashes must be literal.
    py = []
    i = 0
    while i < len(repl):
        ch = repl[i]
        if ch == "%":
            i += 1
            if i >= len(repl):
                raise LuaError("invalid use of '%' in replacement string")
            d = repl[i]
            if d == "%":
                py.append("%")
            elif d.isdigit():
                if d == "0" or (d == "1" and compiled.groups == 0):
                    py.append("\\g<0>")
                else:
                    py.append(f"\\g<{d}>")
            else:
                raise LuaError("invalid use of '%' in replacement string")
        elif ch == "\\":
            py.append("\\\\")
        else:
            py.append(ch)
        i += 1
    try:
        out, cnt = compiled.subn("".join(py), s, count=count)
    except re.error as exc:
        raise LuaError(f"invalid capture in replacement string ({exc})")
    return (out, cnt)


def _to_py(v):
    if isinstance(v, LuaTable):
        n = v.length()
        if n and len(v.hash) == n:
            return [_to_py(v.get(i + 1)) for i in range(n)]
        return {str(k): _to_py(x) for k, x in v.hash.items()}
    return v


def _to_lua(v):
    if isinstance(v, dict):
        return LuaTable({k: _to_lua(x) for k, x in v.items()})
    if isinstance(v, list):
        return LuaTable.from_list([_to_lua(x) for x in v])
    return v


def run(src: str, globals_table: LuaTable):
    """Execute a chunk; returns (return_values_list, interpreter)."""
    interp = Interpreter(globals_table)
    globals_table._interp = interp
    env = Env()
    try:
        interp.exec_block(parse(src), env)
    except _Return as r:
        return r.values, interp
    return [], interp
