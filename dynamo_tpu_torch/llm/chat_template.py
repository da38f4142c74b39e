"""Chat templates: the part of Jinja that HF chat templates use, rendered on
the standard library.

The JAX package renders a model's chat template with
`jinja2.Environment().from_string(t).render(messages=...,
add_generation_prompt=True)`; the card's machine has no `jinja2`.
`ChatTemplate(source)` parses a template into closures once and
`render(**context)` gives the string jinja2 gives, for templates inside
this grammar:

  tags        {{ expr }}, {% if %} / {% elif %} / {% else %} / {% endif %},
              {% for x[, y] in expr %} ... {% endfor %} with loop.index,
              index0, first, last and length; {% set x = expr %},
              {% set ns.attr = expr %} (namespace()), comments, and
              whitespace control with "-"
  literals    strings (Python escapes), integers, floats, true / false /
              none (either case), lists, tuples, dicts
  operators   + - * / // % **, unary - and +, ~, == != < <= > >=, in,
              not in, and, or, not, x if c [else y], is [not] TEST with the
              tests defined, undefined, none, string, mapping, iterable,
              sequence, number, true and false
  access      .attr, [key], [a:b:c]
  filters     trim, length, tojson, upper, lower, first, last, join,
              default, string, int, items, replace
  calls       namespace(); on strings strip, lstrip, rstrip, startswith,
              endswith, split, upper, lower, replace; on dicts get, items,
              keys, values; calling an undefined name (raise_exception,
              which the JAX package never passes)

Semantics are jinja2's defaults: the environment's getattr / getitem
fallbacks, `Undefined` (prints empty, is falsy and iterates empty; an
attribute or item of it, arithmetic on it or calling it raises
`UndefinedError`), a fresh scope for each loop iteration, `tojson` with
sorted keys and HTML-safe escapes, newlines in the template normalized to
"\\n" and one trailing newline dropped. A template outside the grammar
raises `TemplateSyntaxError` when it is parsed; an error while rendering
raises a `TemplateError`.
"""

from __future__ import annotations

import json
import re
from collections import abc
from numbers import Number
from typing import Callable, Optional


class TemplateSyntaxError(ValueError):
    """A template outside the grammar this renderer implements."""


class TemplateError(Exception):
    """An error while rendering (jinja2 raises one of its own there)."""


class UndefinedError(TemplateError):
    """An undefined value was used where jinja2 refuses one."""


class Undefined:
    """jinja2's default Undefined."""

    __slots__ = ("_name", "_obj")

    def __init__(self, name: Optional[str] = None, obj=None) -> None:
        self._name = name
        self._obj = obj

    def _fail(self, *args, **kwargs):
        if self._obj is None:
            raise UndefinedError(f"{self._name!r} is undefined")
        raise UndefinedError(
            f"{type(self._obj).__name__!r} object has no attribute "
            f"{self._name!r}")

    __add__ = __radd__ = __sub__ = __rsub__ = _fail
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _fail
    __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _fail
    __pos__ = __neg__ = __call__ = __getitem__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = _fail
    __int__ = __float__ = __complex__ = __pow__ = __rpow__ = _fail

    def __getattr__(self, name: str):
        if name[:2] == "__":
            raise AttributeError(name)
        self._fail()

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return id(type(self))

    def __str__(self) -> str:
        return ""

    def __len__(self) -> int:
        return 0

    def __iter__(self):
        return iter(())

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return "Undefined"


class Namespace:
    """jinja2's namespace(): attributes settable with {% set ns.a = .. %}."""

    def __init__(self, *args, **kwargs) -> None:
        object.__setattr__(self, "_attrs", dict(*args, **kwargs))

    def __getattr__(self, name: str):
        try:
            return object.__getattribute__(self, "_attrs")[name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self) -> str:
        return f"<Namespace {object.__getattribute__(self, '_attrs')!r}>"


def _getattr(obj, name: str):
    """jinja2's Environment.getattr."""
    try:
        return getattr(obj, name)
    except AttributeError:
        pass
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return Undefined(name, obj)


def _getitem(obj, key):
    """jinja2's Environment.getitem."""
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            try:
                return getattr(obj, key)
            except AttributeError:
                pass
        return Undefined(key, obj)


# -- filters and tests --------------------------------------------------------------


def _tojson(value, indent=None) -> str:
    dumped = json.dumps(value, sort_keys=True, indent=indent)
    return (dumped.replace("<", "\\u003c").replace(">", "\\u003e")
            .replace("&", "\\u0026").replace("'", "\\u0027"))


def _first(seq):
    try:
        return next(iter(seq))
    except StopIteration:
        return Undefined("No first item, sequence was empty.")


def _last(seq):
    try:
        return next(iter(reversed(seq)))
    except StopIteration:
        return Undefined("No last item, sequence was empty.")


def _default(value, default_value="", boolean=False):
    if isinstance(value, Undefined) or (boolean and not value):
        return default_value
    return value


def _int(value, default=0, base=10):
    try:
        if isinstance(value, str):
            return int(value, base)
        return int(value)
    except (TypeError, ValueError):
        try:
            return int(float(value))
        except (TypeError, ValueError):
            return default


def _items(value):
    if isinstance(value, Undefined):
        return iter(())
    if not isinstance(value, abc.Mapping):
        raise TemplateError("Can only get item pairs from a mapping.")
    return iter(value.items())


def _replace(s, old, new, count=None):
    return str(s).replace(str(old), str(new), -1 if count is None else count)


FILTERS: dict[str, Callable] = {
    "trim": lambda s, chars=None: str(s).strip(chars),
    "length": len,
    "tojson": _tojson,
    "upper": lambda s: str(s).upper(),
    "lower": lambda s: str(s).lower(),
    "first": _first, "last": _last,
    "join": lambda v, d="": str(d).join(map(str, v)),
    "default": _default,
    "string": str,
    "int": _int,
    "items": _items,
    "replace": _replace,
}


def _is_sequence(value) -> bool:
    try:
        len(value)
        value.__getitem__
    except Exception:  # noqa: BLE001 — jinja2's test_sequence
        return False
    return True


def _is_iterable(value) -> bool:
    try:
        iter(value)
    except TypeError:
        return False
    return True


TESTS: dict[str, Callable] = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, abc.Mapping),
    "iterable": _is_iterable,
    "sequence": _is_sequence,
    "number": lambda v: isinstance(v, Number),
    "true": lambda v: v is True,
    "false": lambda v: v is False,
}

GLOBALS: dict = {"namespace": Namespace}

# Methods a template may call (on strings and dicts)
METHODS = frozenset({"strip", "lstrip", "rstrip", "startswith", "endswith",
                     "split", "upper", "lower", "replace", "get", "items",
                     "keys", "values"})
LOOP_ATTRS = frozenset({"index", "index0", "first", "last", "length"})


class LoopContext:
    def __init__(self, n: int, i: int) -> None:
        self.index0, self.index = i, i + 1
        self.first, self.last, self.length = i == 0, i == n - 1, n


# -- lexer --------------------------------------------------------------------------

_NEWLINE = re.compile(r"(\r\n|\r|\n)")
_OPEN = re.compile(r"\{\{|\{%|\{#")
_WS = re.compile(r"\s+")
_NAME = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?e[+\-]?(\d+_)*\d+"
                    r"|\.(\d+_)*\d+)", re.I)
_INT = re.compile(r"(\d+_)*\d+")
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'"
                     r'|"([^"\\]*(?:\\.[^"\\]*)*)")', re.S)
_OPERATORS = ("//", "**", "==", "!=", "<=", ">=", "+", "-", "/", "*", "%",
              "~", "<", ">", "=", ".", ":", "|", ",", "(", ")", "[", "]",
              "{", "}")
_CLOSE = {"{{": "}}", "{%": "%}"}


def _lex(source: str) -> list:
    """[("data", text) | ("var" | "block", [tokens])]; a token is (kind,
    value) with kind in name, int, float, str, op."""
    lines = _NEWLINE.split(source)[::2]
    if lines and lines[-1] == "":
        del lines[-1]
    source = "\n".join(lines)
    out: list = []
    pos, n = 0, len(source)
    strip_next = False
    while pos < n:
        m = _OPEN.search(source, pos)
        data = source[pos:m.start() if m else n]
        if m and source.startswith("-", m.end()):
            data = data.rstrip()
        if strip_next:
            data = data.lstrip()
        strip_next = False
        if data:
            out.append(("data", data))
        if not m:
            break
        pos = m.end()
        if pos < n and source[pos] == "-":
            pos += 1
        if m.group(0) == "{#":
            end = source.find("#}", pos)
            if end < 0:
                raise TemplateSyntaxError("unclosed comment")
            strip_next = source[end - 1] == "-" and end > pos
            pos = end + 2
            continue
        close = _CLOSE[m.group(0)]
        tokens = []
        while True:
            ws = _WS.match(source, pos)
            if ws:
                pos = ws.end()
            if pos >= n:
                raise TemplateSyntaxError(f"unclosed {m.group(0)!r} tag")
            if source.startswith(close, pos):
                pos += 2
                break
            if source[pos] == "-" and source.startswith(close, pos + 1):
                strip_next = True
                pos += 3
                break
            tok = _NAME.match(source, pos)
            if tok:
                tokens.append(("name", tok.group(0)))
                pos = tok.end()
                continue
            tok = _FLOAT.match(source, pos)
            if tok:
                tokens.append(("float", float(tok.group(0).replace("_", ""))))
                pos = tok.end()
                continue
            tok = _INT.match(source, pos)
            if tok:
                tokens.append(("int", int(tok.group(0).replace("_", ""))))
                pos = tok.end()
                continue
            tok = _STRING.match(source, pos)
            if tok:
                raw = _NEWLINE.sub("\n", tok.group(0)[1:-1])
                tokens.append(("str", raw.encode("ascii", "backslashreplace")
                               .decode("unicode-escape")))
                pos = tok.end()
                continue
            for op in _OPERATORS:
                if source.startswith(op, pos):
                    tokens.append(("op", op))
                    pos += len(op)
                    break
            else:
                raise TemplateSyntaxError(
                    f"unexpected character {source[pos]!r}")
        out.append(("var" if m.group(0) == "{{" else "block", tokens))
    return out


# -- parser: expressions -> closures of the context --------------------------------

_CONSTANTS = {"true": True, "True": True, "false": False, "False": False,
              "none": None, "None": None}
_COMPARE = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b,
            "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
            ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}
_ARITH = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
          "*": lambda a, b: a * b, "/": lambda a, b: a / b,
          "//": lambda a, b: a // b, "%": lambda a, b: a % b}


def _concat(values) -> str:
    return "".join(map(str, values))


class _Tokens:
    def __init__(self, tokens: list) -> None:
        self.tokens = tokens
        self.i = 0

    def peek(self, offset: int = 0):
        j = self.i + offset
        return self.tokens[j] if j < len(self.tokens) else ("end", None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def at(self, kind: str, value=None, offset: int = 0) -> bool:
        k, v = self.peek(offset)
        return k == kind and (value is None or v == value)

    def take(self, kind: str, value=None):
        if not self.at(kind, value):
            raise TemplateSyntaxError(
                f"expected {value or kind}, got {self.peek()[1]!r}")
        return self.next()[1]

    def done(self) -> bool:
        return self.i >= len(self.tokens)


class _ExprParser:
    def __init__(self, toks: _Tokens) -> None:
        self.t = toks
        self._last_name: Optional[str] = None

    def expression(self):
        node = self.or_()
        while self.t.at("name", "if"):
            self.t.next()
            cond = self.or_()
            other = None
            if self.t.at("name", "else"):
                self.t.next()
                other = self.expression()
            node = self._cond(node, cond, other)
        return node

    @staticmethod
    def _cond(then, cond, other):
        if other is None:
            return lambda c: then(c) if cond(c) else Undefined()
        return lambda c: then(c) if cond(c) else other(c)

    def or_(self):
        node = self.and_()
        while self.t.at("name", "or"):
            self.t.next()
            left, right = node, self.and_()
            node = lambda c, a=left, b=right: a(c) or b(c)  # noqa: E731
        return node

    def and_(self):
        node = self.not_()
        while self.t.at("name", "and"):
            self.t.next()
            left, right = node, self.not_()
            node = lambda c, a=left, b=right: a(c) and b(c)  # noqa: E731
        return node

    def not_(self):
        if self.t.at("name", "not"):
            self.t.next()
            inner = self.not_()
            return lambda c: not inner(c)
        return self.compare()

    def compare(self):
        node = self.math1()
        while True:
            if self.t.at("op") and self.t.peek()[1] in _COMPARE:
                fn = _COMPARE[self.t.next()[1]]
            elif self.t.at("name", "in"):
                self.t.next()
                fn = lambda a, b: a in b  # noqa: E731
            elif self.t.at("name", "not") and self.t.at("name", "in", 1):
                self.t.next()
                self.t.next()
                fn = lambda a, b: a not in b  # noqa: E731
            else:
                return node
            left, right = node, self.math1()
            node = (lambda c, f=fn, a=left, b=right: f(a(c), b(c)))

    def _binary(self, ops, sub):
        node = sub()
        while self.t.at("op") and self.t.peek()[1] in ops:
            fn = _ARITH[self.t.next()[1]]
            left, right = node, sub()
            node = (lambda c, f=fn, a=left, b=right: f(a(c), b(c)))
        return node

    def math1(self):
        return self._binary(("+", "-"), self.concat)

    def concat(self):
        parts = [self.math2()]
        while self.t.at("op", "~"):
            self.t.next()
            parts.append(self.math2())
        if len(parts) == 1:
            return parts[0]
        return lambda c: _concat(p(c) for p in parts)

    def math2(self):
        return self._binary(("*", "/", "//", "%"), self.pow_)

    def pow_(self):
        node = self.unary()
        while self.t.at("op", "**"):
            self.t.next()
            left, right = node, self.unary()
            node = lambda c, a=left, b=right: a(c) ** b(c)  # noqa: E731
        return node

    def unary(self, with_filter: bool = True):
        if self.t.at("op", "-"):
            self.t.next()
            inner = self.unary(False)
            node = lambda c: -inner(c)  # noqa: E731
        elif self.t.at("op", "+"):
            self.t.next()
            inner = self.unary(False)
            node = lambda c: +inner(c)  # noqa: E731
        else:
            node = self.postfix(self.primary())
        return self.filters(node) if with_filter else node

    def primary(self):
        kind, value = self.t.next()
        self._last_name = None  # the name an attribute is taken of
        if kind == "name":
            if value in _CONSTANTS:
                const = _CONSTANTS[value]
                return lambda c: const
            if value.startswith("_"):
                raise TemplateSyntaxError(f"name {value!r}")
            self._last_name = value
            return lambda c: c.lookup(value)
        if kind in ("str", "int", "float"):
            return lambda c: value
        if kind == "op" and value == "(":
            if self.t.at("op", ")"):
                self.t.next()
                return lambda c: ()
            first = self.expression()
            if self.t.at("op", ","):
                items = [first]
                while self.t.at("op", ","):
                    self.t.next()
                    if self.t.at("op", ")"):
                        break
                    items.append(self.expression())
                self.t.take("op", ")")
                return lambda c: tuple(i(c) for i in items)
            self.t.take("op", ")")
            return first
        if kind == "op" and value == "[":
            items = self._items("]")
            return lambda c: [i(c) for i in items]
        if kind == "op" and value == "{":
            pairs = []
            while not self.t.at("op", "}"):
                if pairs:
                    self.t.take("op", ",")
                    if self.t.at("op", "}"):
                        break
                key = self.expression()
                self.t.take("op", ":")
                pairs.append((key, self.expression()))
            self.t.take("op", "}")
            return lambda c: {k(c): v(c) for k, v in pairs}
        raise TemplateSyntaxError(f"unexpected {value!r}")

    def _items(self, close: str) -> list:
        items = []
        while not self.t.at("op", close):
            if items:
                self.t.take("op", ",")
                if self.t.at("op", close):
                    break
            items.append(self.expression())
        self.t.take("op", close)
        return items

    def postfix(self, node):
        while True:
            if self.t.at("op", "."):
                self.t.next()
                kind, name = self.t.next()
                if kind != "name" or name.startswith("_"):
                    raise TemplateSyntaxError(f"attribute {name!r}")
                if self.t.at("op", "("):
                    if name not in METHODS:
                        raise TemplateSyntaxError(f"method {name!r}")
                elif self._last_name == "loop" and name not in LOOP_ATTRS:
                    raise TemplateSyntaxError(f"loop.{name}")
                self._last_name = None
                node = (lambda c, n=node, k=name: _getattr(n(c), k))
            elif self.t.at("op", "["):
                self.t.next()
                key = self._subscript()
                self.t.take("op", "]")
                node = (lambda c, n=node, k=key: _getitem(n(c), k(c)))
            elif self.t.at("op", "("):
                node = self.call(node)
            else:
                return node

    def _subscript(self):
        parts: list = [None, None, None]
        idx = 0
        if not self.t.at("op", ":"):
            parts[0] = self.expression()
            if not self.t.at("op", ":"):
                return parts[0]
        while self.t.at("op", ":") and idx < 2:
            self.t.next()
            idx += 1
            if not (self.t.at("op", ":") or self.t.at("op", "]")):
                parts[idx] = self.expression()

        def make_slice(c):
            return slice(*(p(c) if p else None for p in parts))
        return make_slice

    def _args(self):
        self.t.take("op", "(")
        args, kwargs = [], {}
        while not self.t.at("op", ")"):
            if args or kwargs:
                self.t.take("op", ",")
                if self.t.at("op", ")"):
                    break
            if self.t.at("name") and self.t.at("op", "=", 1):
                key = self.t.next()[1]
                self.t.next()
                kwargs[key] = self.expression()
            else:
                if kwargs:
                    raise TemplateSyntaxError("positional after keyword")
                args.append(self.expression())
        self.t.take("op", ")")
        return args, kwargs

    def call(self, fn):
        args, kwargs = self._args()
        return lambda c: fn(c)(*(a(c) for a in args),
                               **{k: v(c) for k, v in kwargs.items()})

    def filters(self, node):
        while True:
            if self.t.at("op", "|"):
                self.t.next()
                name = self.t.take("name")
                if name not in FILTERS:
                    raise TemplateSyntaxError(f"filter {name!r}")
                args, kwargs = (self._args() if self.t.at("op", "(")
                                else ([], {}))
                node = (lambda c, f=FILTERS[name], n=node, a=args, k=kwargs:
                        f(n(c), *(x(c) for x in a),
                          **{key: v(c) for key, v in k.items()}))
            elif self.t.at("name", "is"):
                self.t.next()
                negate = self.t.at("name", "not")
                if negate:
                    self.t.next()
                name = self.t.take("name")
                if name not in TESTS or self.t.at("op", "("):
                    raise TemplateSyntaxError(f"test {name!r}")
                node = (lambda c, f=TESTS[name], n=node, neg=negate:
                        bool(f(n(c))) != neg)
            elif self.t.at("op", "("):
                node = self.call(node)
            else:
                return node


def _parse_expr(tokens: list, what: str):
    toks = _Tokens(tokens)
    node = _ExprParser(toks).expression()
    if not toks.done():
        raise TemplateSyntaxError(f"unexpected {toks.peek()[1]!r} in {what}")
    return node


# -- parser: statements ---------------------------------------------------------------


class _Context:
    def __init__(self, variables: dict) -> None:
        self.scopes = [dict(variables)]

    def lookup(self, name: str):
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        if name in GLOBALS:
            return GLOBALS[name]
        return Undefined(name)


def _targets(toks: _Tokens) -> list:
    names = [toks.take("name")]
    while toks.at("op", ","):
        toks.next()
        names.append(toks.take("name"))
    return names


def _bind(names: list, value) -> dict:
    if len(names) == 1:
        return {names[0]: value}
    values = list(value)
    if len(values) != len(names):
        raise TemplateError(f"cannot unpack {len(values)} values into "
                            f"{len(names)} names")
    return dict(zip(names, values))


class _BlockParser:
    def __init__(self, items: list) -> None:
        self.items = items
        self.i = 0

    def body(self, ends: tuple) -> tuple:
        """Statements until a block whose keyword is in `ends`; returns
        (nodes, that keyword and its tokens)."""
        nodes: list = []
        while self.i < len(self.items):
            kind, value = self.items[self.i]
            self.i += 1
            if kind == "data":
                nodes.append(lambda c, out, s=value: out.append(s))
            elif kind == "var":
                nodes.append(self._output(value))
            else:
                toks = _Tokens(value)
                keyword = toks.take("name")
                if keyword in ends:
                    return nodes, keyword, toks
                nodes.append(self._statement(keyword, toks))
        if ends:
            raise TemplateSyntaxError(f"missing {' / '.join(ends)}")
        return nodes, None, None

    @staticmethod
    def _output(tokens):
        expr = _parse_expr(tokens, "{{ }}")

        def output(c, out):
            value = expr(c)
            out.append(str(value))
        return output

    def _statement(self, keyword: str, toks: _Tokens):
        if keyword == "if":
            return self._if(toks)
        if keyword == "for":
            return self._for(toks)
        if keyword == "set":
            return self._set(toks)
        raise TemplateSyntaxError(f"tag {keyword!r}")

    def _if(self, toks: _Tokens):
        branches = []
        cond = _parse_expr(toks.tokens[toks.i:], "if")
        while True:
            nodes, end, rest = self.body(("elif", "else", "endif"))
            branches.append((cond, nodes))
            if end == "elif":
                cond = _parse_expr(rest.tokens[rest.i:], "elif")
            elif end == "else":
                if not rest.done():
                    raise TemplateSyntaxError("else takes nothing")
                nodes, _, rest = self.body(("endif",))
                branches.append((None, nodes))
                break
            else:
                break
        if not rest.done():
            raise TemplateSyntaxError("endif takes nothing")

        def run(c, out):
            for cond, nodes in branches:
                if cond is None or cond(c):
                    for node in nodes:
                        node(c, out)
                    return
        return run

    def _for(self, toks: _Tokens):
        names = _targets(toks)
        toks.take("name", "in")
        rest = toks.tokens[toks.i:]
        depth = 0
        for kind, value in rest:  # jinja2 reads a top-level "if" here as a
            if kind == "op" and value in "([{":  # loop filter: not this
                depth += 1                         # grammar
            elif kind == "op" and value in ")]}":
                depth -= 1
            elif (kind, value) == ("name", "if") and depth == 0:
                raise TemplateSyntaxError("loop filters")
        iterable = _parse_expr(rest, "for")
        body, _, end_toks = self.body(("endfor",))
        if not end_toks.done():
            raise TemplateSyntaxError("endfor takes nothing")

        def run(c, out):
            items = list(iterable(c))
            for i, item in enumerate(items):
                scope = _bind(names, item)
                scope["loop"] = LoopContext(len(items), i)
                c.scopes.append(scope)
                try:
                    for node in body:
                        node(c, out)
                finally:
                    c.scopes.pop()
        return run

    def _set(self, toks: _Tokens):
        if toks.at("name") and toks.at("op", ".", 1):
            target = toks.take("name")
            toks.next()
            attr = toks.take("name")
            if attr.startswith("_"):
                raise TemplateSyntaxError(f"attribute {attr!r}")
            toks.take("op", "=")
            value = _parse_expr(toks.tokens[toks.i:], "set")

            def set_attr(c, out):
                ns = c.lookup(target)
                if not isinstance(ns, Namespace):
                    raise TemplateError("cannot assign attribute on "
                                        "non-namespace object")
                object.__getattribute__(ns, "_attrs")[attr] = value(c)
            return set_attr
        name = toks.take("name")
        if not toks.at("op", "="):
            raise TemplateSyntaxError("block set")
        toks.next()
        value = _parse_expr(toks.tokens[toks.i:], "set")

        def set_var(c, out):
            c.scopes[-1][name] = value(c)
        return set_var


class ChatTemplate:
    """A template parsed once; `render(**variables)` as jinja2 renders it."""

    def __init__(self, source: str) -> None:
        self.source = source
        try:
            self._nodes, _, _ = _BlockParser(_lex(source)).body(())
        except TemplateSyntaxError:
            raise
        except (ValueError, IndexError, TypeError) as exc:
            raise TemplateSyntaxError(str(exc)) from None

    def render(self, **variables) -> str:
        ctx = _Context(variables)
        out: list[str] = []
        try:
            for node in self._nodes:
                node(ctx, out)
        except TemplateError:
            raise
        except Exception as exc:  # noqa: BLE001 — any failure is the template's
            raise TemplateError(f"{type(exc).__name__}: {exc}") from exc
        return "".join(out)
