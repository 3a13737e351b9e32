"""Painless-subset interpreter: tokenizer, recursive-descent parser, evaluator.

The analog of the reference's sandboxed script language
(modules/lang-painless: ANTLR grammar -> AST -> ASM bytecode with per-context
allowlists). Here the language is interpreted over a closed set of value
types and namespaces — there is no route from a script to the host runtime:
no imports, no attribute access on arbitrary Python objects (only dicts,
lists, strings, numbers and the Doc/FieldValues views), no dunder names.

Supported syntax (covers the idiomatic scripts in the reference's docs/tests):
  literals, arithmetic, comparison, &&/||/!, ternary, parentheses,
  member access (a.b / a['b'] / a[0]), method calls on strings/lists/maps,
  Math.*, doc['field'].value / .values / .size(), params.x, _score,
  ctx._source.field assignment (=, +=, -=, *=, /=), local variable
  declarations (`def x = ...`, `double y = ...`), if/else blocks,
  return, `;`-separated statements, string concatenation with +.
"""

from __future__ import annotations

import math
import re
from typing import Any

from opensearch_tpu_torch.common.errors import OpenSearchTpuException


class ScriptException(OpenSearchTpuException):
    status = 400
    error_type = "script_exception"


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|//[^\n]*)
  | (?P<num>\d+\.\d+[fFdD]?|\d+[lLfFdD]?)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|==|!=|&&|\|\||\+=|-=|\*=|/=|%=|\+\+|--|[-+*/%<>=!?:;.,(){}\[\]])
""", re.VERBOSE)

_TYPE_NAMES = {"def", "int", "long", "float", "double", "boolean", "String",
               "Object", "List", "Map", "var"}
_KEYWORDS = {"true", "false", "null", "if", "else", "return", "for", "while"}


def tokenize(src: str) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise ScriptException(f"unexpected character [{src[pos]}] at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group(0)))
    return out


# -- AST nodes (plain tuples: (kind, ...)) ---------------------------------


class Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else (None, None)

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value: str):
        kind, v = self.peek()
        if v != value:
            raise ScriptException(f"expected [{value}] but found [{v}]")
        return self.next()

    def at_end(self) -> bool:
        return self.i >= len(self.toks)

    # -- statements --------------------------------------------------------

    def parse_program(self):
        stmts = []
        while not self.at_end():
            stmts.append(self.parse_statement())
        return ("block", stmts)

    def parse_block(self):
        if self.peek()[1] == "{":
            self.next()
            stmts = []
            while self.peek()[1] != "}":
                if self.at_end():
                    raise ScriptException("unclosed block")
                stmts.append(self.parse_statement())
            self.next()
            return ("block", stmts)
        return self.parse_statement()

    def parse_statement(self):
        kind, v = self.peek()
        if v == ";":
            self.next()
            return ("nop",)
        if v == "return":
            self.next()
            if self.peek()[1] in (";", None):
                expr = ("lit", None)
            else:
                expr = self.parse_expr()
            if self.peek()[1] == ";":
                self.next()
            return ("return", expr)
        if v == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_block()
            other = None
            if self.peek()[1] == "else":
                self.next()
                other = self.parse_block()
            return ("if", cond, then, other)
        if v == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            body = self.parse_block()
            return ("while", cond, body)
        if v == "for":
            self.next()
            self.expect("(")
            # enhanced for: `for (def x : iter)` / `for (x in iter)`
            probe = 0
            if self.peek()[1] in _TYPE_NAMES:
                probe = 1
            if (self.peek(probe)[0] == "name"
                    and self.peek(probe + 1)[1] in (":", "in")):
                for _ in range(probe):
                    self.next()
                var = self.next()[1]
                self.next()  # ':' or 'in'
                it = self.parse_expr()
                self.expect(")")
                body = self.parse_block()
                return ("foreach", var, it, body)
            init = self.parse_statement()
            cond = self.parse_expr()
            self.expect(";")
            update = self.parse_statement()
            self.expect(")")
            body = self.parse_block()
            return ("cfor", init, cond, update, body)
        if v == "break":
            self.next()
            if self.peek()[1] == ";":
                self.next()
            return ("break",)
        if v == "continue":
            self.next()
            if self.peek()[1] == ";":
                self.next()
            return ("continue",)
        # typed local declaration: `def x = expr` / `double y = expr`
        if v in _TYPE_NAMES and self.peek(1)[0] == "name" and self.peek(2)[1] == "=":
            self.next()
            name = self.next()[1]
            self.expect("=")
            expr = self.parse_expr()
            if self.peek()[1] == ";":
                self.next()
            return ("assign", ("name", name), expr)
        expr = self.parse_expr()
        nk, nv = self.peek()
        if nv in ("++", "--"):
            self.next()
            if self.peek()[1] == ";":
                self.next()
            return ("augassign", expr, nv[0], ("lit", 1))
        if nv in ("=", "+=", "-=", "*=", "/=", "%="):
            self.next()
            rhs = self.parse_expr()
            if self.peek()[1] == ";":
                self.next()
            if nv == "=":
                return ("assign", expr, rhs)
            return ("augassign", expr, nv[0], rhs)
        if nv == ";":
            self.next()
        return ("expr", expr)

    # -- expressions -------------------------------------------------------

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        cond = self.parse_or()
        if self.peek()[1] == "?":
            self.next()
            a = self.parse_expr()
            self.expect(":")
            b = self.parse_expr()
            return ("ternary", cond, a, b)
        return cond

    def _binop_level(self, sub, ops):
        node = sub()
        while self.peek()[1] in ops:
            op = self.next()[1]
            node = ("binop", op, node, sub())
        return node

    def parse_or(self):
        return self._binop_level(self.parse_and, ("||",))

    def parse_and(self):
        return self._binop_level(self.parse_eq, ("&&",))

    def parse_eq(self):
        return self._binop_level(self.parse_cmp, ("==", "!="))

    def parse_cmp(self):
        return self._binop_level(self.parse_add, ("<", "<=", ">", ">="))

    def parse_add(self):
        return self._binop_level(self.parse_mul, ("+", "-"))

    def parse_mul(self):
        return self._binop_level(self.parse_unary, ("*", "/", "%"))

    def parse_unary(self):
        kind, v = self.peek()
        if v in ("!", "-"):
            self.next()
            return ("unary", v, self.parse_unary())
        if v == "+":
            self.next()
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self):
        node = self.parse_primary()
        while True:
            kind, v = self.peek()
            if v == ".":
                self.next()
                nkind, name = self.next()
                if nkind != "name":
                    raise ScriptException(f"expected member name, found [{name}]")
                if "__" in name:
                    raise ScriptException(f"illegal member name [{name}]")
                if self.peek()[1] == "(":
                    args = self.parse_args()
                    node = ("call", node, name, args)
                else:
                    node = ("member", node, name)
            elif v == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                node = ("index", node, idx)
            elif v == "(" and node[0] == "name":
                args = self.parse_args()
                node = ("fncall", node[1], args)
            else:
                return node

    def parse_args(self):
        self.expect("(")
        args = []
        while self.peek()[1] != ")":
            args.append(self.parse_expr())
            if self.peek()[1] == ",":
                self.next()
        self.expect(")")
        return args

    def parse_primary(self):
        kind, v = self.next() if not self.at_end() else (None, None)
        if kind == "num":
            raw = v.rstrip("lLfFdD")
            return ("lit", float(raw) if "." in raw else int(raw))
        if kind == "str":
            body = v[1:-1]
            return ("lit", body.replace("\\'", "'").replace('\\"', '"')
                    .replace("\\\\", "\\").replace("\\n", "\n"))
        if kind == "name":
            if v == "true":
                return ("lit", True)
            if v == "false":
                return ("lit", False)
            if v == "null":
                return ("lit", None)
            if "__" in v:
                raise ScriptException(f"illegal identifier [{v}]")
            return ("name", v)
        if v == "(":
            node = self.parse_expr()
            self.expect(")")
            return node
        if v == "[":
            items = []
            while self.peek()[1] != "]":
                items.append(self.parse_expr())
                if self.peek()[1] == ",":
                    self.next()
            self.expect("]")
            return ("list", items)
        raise ScriptException(f"unexpected token [{v}]")


def compile_script(source: str):
    """source -> AST (cached by ScriptService)."""
    return Parser(tokenize(source)).parse_program()


# --------------------------------------------------------------------------
# runtime values
# --------------------------------------------------------------------------


class FieldValues:
    """doc['field'] — the script doc-values view (sorted multi-values)."""

    __slots__ = ("_vals",)

    def __init__(self, vals: list):
        self._vals = vals

    @property
    def value(self):
        if not self._vals:
            raise ScriptException(
                "A document doesn't have a value for a field! "
                "Use doc[<field>].size()==0 to check if a document is missing a field!"
            )
        return self._vals[0]

    @property
    def values(self):
        return list(self._vals)

    @property
    def empty(self):
        return not self._vals

    @property
    def length(self):
        return len(self._vals)

    def methods(self, name: str, args: list):
        if name == "size":
            return len(self._vals)
        if name == "isEmpty":
            return not self._vals
        if name == "contains":
            return args[0] in self._vals
        if name == "get":
            return self._vals[int(args[0])]
        raise ScriptException(f"unknown method [{name}] on doc values")


class DocView:
    """doc — lazy per-document columnar access."""

    __slots__ = ("_host", "_doc", "_ms")

    def __init__(self, host, doc: int, mapper_service):
        self._host = host
        self._doc = doc
        self._ms = mapper_service

    def __getitem__(self, field: str) -> FieldValues:
        from opensearch_tpu_torch.search.fetch import _doc_column_values

        return FieldValues(
            _doc_column_values(self._host, self._doc, field, self._ms, None)
        )

    def methods(self, name: str, args: list):
        if name == "containsKey":
            f = args[0]
            return (f in self._host.numeric_fields or f in self._host.keyword_fields
                    or f in self._host.text_fields or f in self._host.vector_fields)
        raise ScriptException(f"unknown method [{name}] on doc")


_MATH = {
    "log": math.log, "log10": math.log10, "max": max, "min": min,
    "abs": abs, "pow": math.pow, "sqrt": math.sqrt, "floor": math.floor,
    "ceil": math.ceil, "exp": math.exp, "round": round,
    "E": math.e, "PI": math.pi,
}


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class Evaluator:
    def __init__(self, env: dict[str, Any]):
        self.env = dict(env)
        self._loop_iters = 0

    # -- statements --------------------------------------------------------

    def run(self, node) -> Any:
        try:
            last = self._stmt(node)
        except _Return as r:
            return r.value
        except (_Break, _Continue):
            raise ScriptException("break/continue outside of a loop")
        except ScriptException:
            raise
        except (KeyError, ValueError, IndexError, TypeError, AttributeError,
                ZeroDivisionError, OverflowError, re.error) as e:
            # user-script runtime faults surface as 400 script_exception,
            # never a raw 500 (PainlessError semantics)
            raise ScriptException(f"runtime error in script: {e}")
        return last

    def _stmt(self, node) -> Any:
        kind = node[0]
        if kind == "block":
            last = None
            for s in node[1]:
                last = self._stmt(s)
            return last
        if kind == "nop":
            return None
        if kind == "return":
            raise _Return(self.eval(node[1]))
        if kind == "if":
            if _truthy(self.eval(node[1])):
                return self._stmt(node[2])
            if node[3] is not None:
                return self._stmt(node[3])
            return None
        if kind == "assign":
            value = self.eval(node[2])
            self._store(node[1], value)
            return None
        if kind == "augassign":
            cur = self.eval(node[1])
            value = _binop(node[2], cur, self.eval(node[3]))
            self._store(node[1], value)
            return None
        if kind == "expr":
            return self.eval(node[1])
        if kind == "while":
            n = 0
            while _truthy(self.eval(node[1])):
                self._bump_loop(n)
                n += 1
                try:
                    self._stmt(node[2])
                except _Break:
                    break
                except _Continue:
                    continue
            return None
        if kind == "foreach":
            it = self.eval(node[2])
            if it is None:
                raise ScriptException("cannot iterate over null")
            if isinstance(it, dict):
                it = list(it.keys())
            for n, item in enumerate(it):
                self._bump_loop(n)
                self.env[node[1]] = item
                try:
                    self._stmt(node[3])
                except _Break:
                    break
                except _Continue:
                    continue
            return None
        if kind == "cfor":
            self._stmt(node[1])
            n = 0
            while _truthy(self.eval(node[2])):
                self._bump_loop(n)
                n += 1
                try:
                    self._stmt(node[4])
                except _Break:
                    break
                except _Continue:
                    pass
                self._stmt(node[3])
            return None
        if kind == "break":
            raise _Break()
        if kind == "continue":
            raise _Continue()
        raise ScriptException(f"unknown statement [{kind}]")

    def _bump_loop(self, _n: int) -> None:
        # the reference compiles in a loop counter that throws after too many
        # iterations (CompilerSettings MAX_LOOP_COUNTER); same guard here
        self._loop_iters += 1
        if self._loop_iters > 1_000_000:
            raise ScriptException("loop limit exceeded [1000000]")

    def _store(self, target, value) -> None:
        kind = target[0]
        if kind == "name":
            self.env[target[1]] = value
            return
        if kind == "member":
            obj = self.eval(target[1])
            if isinstance(obj, dict):
                obj[target[2]] = value
                return
            raise ScriptException(f"cannot assign member [{target[2]}]")
        if kind == "index":
            obj = self.eval(target[1])
            idx = self.eval(target[2])
            if isinstance(obj, dict):
                obj[idx] = value
                return
            if isinstance(obj, list):
                obj[int(idx)] = value
                return
        raise ScriptException("invalid assignment target")

    # -- expressions -------------------------------------------------------

    def eval(self, node) -> Any:
        kind = node[0]
        if kind == "lit":
            return node[1]
        if kind == "name":
            name = node[1]
            if name in self.env:
                return self.env[name]
            if name == "Math":
                return _MATH
            raise ScriptException(f"unknown variable [{name}]")
        if kind == "list":
            return [self.eval(x) for x in node[1]]
        if kind == "ternary":
            return self.eval(node[2]) if _truthy(self.eval(node[1])) else self.eval(node[3])
        if kind == "binop":
            op = node[1]
            if op == "&&":
                return _truthy(self.eval(node[2])) and _truthy(self.eval(node[3]))
            if op == "||":
                return _truthy(self.eval(node[2])) or _truthy(self.eval(node[3]))
            return _binop(op, self.eval(node[2]), self.eval(node[3]))
        if kind == "unary":
            v = self.eval(node[2])
            return (not _truthy(v)) if node[1] == "!" else -v
        if kind == "member":
            return self._member(self.eval(node[1]), node[2])
        if kind == "index":
            obj = self.eval(node[1])
            idx = self.eval(node[2])
            if isinstance(obj, DocView):
                return obj[str(idx)]
            if isinstance(obj, dict):
                return obj.get(idx)
            if isinstance(obj, (list, str)):
                return obj[int(idx)]
            raise ScriptException(f"cannot index [{type(obj).__name__}]")
        if kind == "call":
            obj = self.eval(node[1])
            args = [self.eval(a) for a in node[3]]
            return self._method(obj, node[2], args)
        if kind == "fncall":
            raise ScriptException(f"unknown function [{node[1]}]")
        raise ScriptException(f"unknown expression [{kind}]")

    def _member(self, obj, name: str):
        if isinstance(obj, FieldValues):
            if name in ("value", "values", "empty", "length"):
                return getattr(obj, name)
            raise ScriptException(f"unknown doc-values member [{name}]")
        if isinstance(obj, dict):
            if obj is _MATH:
                if name not in _MATH:
                    raise ScriptException(f"unknown Math member [{name}]")
                return _MATH[name]
            return obj.get(name)
        if isinstance(obj, str) and name == "length":
            return len(obj)
        if isinstance(obj, list) and name == "length":
            return len(obj)
        raise ScriptException(
            f"cannot access member [{name}] on [{type(obj).__name__}]"
        )

    def _method(self, obj, name: str, args: list):
        if hasattr(obj, "methods"):
            return obj.methods(name, args)
        if obj is _MATH or (isinstance(obj, dict) and obj is _MATH):
            fn = _MATH.get(name)
            if fn is None or not callable(fn):
                raise ScriptException(f"unknown Math function [{name}]")
            return fn(*args)
        if isinstance(obj, str):
            return _str_method(obj, name, args)
        if isinstance(obj, list):
            return _list_method(obj, name, args)
        if isinstance(obj, dict):
            return _map_method(obj, name, args)
        if isinstance(obj, (int, float)) and name in ("intValue", "longValue",
                                                      "doubleValue", "floatValue"):
            return int(obj) if name in ("intValue", "longValue") else float(obj)
        raise ScriptException(
            f"unknown method [{name}] on [{type(obj).__name__}]"
        )


def _truthy(v) -> bool:
    if v is None:
        return False
    return bool(v)


def _binop(op: str, a, b):
    try:
        if op == "+":
            if isinstance(a, str) or isinstance(b, str):
                return _to_str(a) + _to_str(b)
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if isinstance(a, int) and isinstance(b, int):
                if b == 0:
                    raise ScriptException("/ by zero")
                return a // b if (a < 0) == (b < 0) or a % b == 0 else -((-a) // b)
            return a / b
        if op == "%":
            return a % b
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
    except ScriptException:
        raise
    except ZeroDivisionError:
        raise ScriptException("/ by zero")
    except TypeError as e:
        raise ScriptException(f"bad operands for [{op}]: {e}")
    raise ScriptException(f"unknown operator [{op}]")


def _to_str(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return f"{v:.1f}"
    return str(v)


def _str_method(s: str, name: str, args: list):
    table = {
        "length": lambda: len(s),
        "contains": lambda: str(args[0]) in s,
        "substring": lambda: s[int(args[0]):] if len(args) == 1
        else s[int(args[0]):int(args[1])],
        "toLowerCase": lambda: s.lower(),
        "toUpperCase": lambda: s.upper(),
        "startsWith": lambda: s.startswith(str(args[0])),
        "endsWith": lambda: s.endswith(str(args[0])),
        "indexOf": lambda: s.find(str(args[0])),
        "replace": lambda: s.replace(str(args[0]), str(args[1])),
        "split": lambda: re.split(str(args[0]), s),
        "trim": lambda: s.strip(),
        "equals": lambda: s == args[0],
        "equalsIgnoreCase": lambda: s.lower() == str(args[0]).lower(),
        "isEmpty": lambda: len(s) == 0,
        "charAt": lambda: s[int(args[0])],
        "toString": lambda: s,
    }
    fn = table.get(name)
    if fn is None:
        raise ScriptException(f"unknown String method [{name}]")
    return fn()


def _list_method(lst: list, name: str, args: list):
    table = {
        "size": lambda: len(lst),
        "isEmpty": lambda: len(lst) == 0,
        "contains": lambda: args[0] in lst,
        "get": lambda: lst[int(args[0])],
        "add": lambda: lst.append(args[0]),
        "remove": lambda: lst.pop(int(args[0])) if isinstance(args[0], int)
        else lst.remove(args[0]),
        "indexOf": lambda: lst.index(args[0]) if args[0] in lst else -1,
        "sort": lambda: lst.sort(),
        "toString": lambda: str(lst),
    }
    fn = table.get(name)
    if fn is None:
        raise ScriptException(f"unknown List method [{name}]")
    return fn()


def _map_method(m: dict, name: str, args: list):
    table = {
        "containsKey": lambda: args[0] in m,
        "get": lambda: m.get(args[0]),
        "getOrDefault": lambda: m.get(args[0], args[1]),
        "put": lambda: m.__setitem__(args[0], args[1]),
        "remove": lambda: m.pop(args[0], None),
        "keySet": lambda: list(m.keys()),
        "values": lambda: list(m.values()),
        "size": lambda: len(m),
        "isEmpty": lambda: len(m) == 0,
        "entrySet": lambda: [{"key": k, "value": v} for k, v in m.items()],
    }
    fn = table.get(name)
    if fn is None:
        raise ScriptException(f"unknown Map method [{name}]")
    return fn()
