"""Chat templates: Jinja, as a default `jinja2.Environment()` renders it, on
the standard library.

The JAX package renders a model's chat template with
`jinja2.Environment().from_string(t).render(messages=...,
add_generation_prompt=True)`; the card's machine has no `jinja2`.
`ChatTemplate(source)` lexes and parses a template into a tree, compiles the
tree into closures once, and `render(**context)` gives the string jinja2
gives:

  tags        {{ expr }}, {% if %} / {% elif %} / {% else %}, {% for %}
              (tuple targets, a `for ... if cond` filter, for-else,
              `recursive` with `loop(...)`), {% set x = expr %},
              {% set a, b = ... %}, {% set ns.attr = expr %},
              {% set x [| filter] %}...{% endset %}, {% macro name(args,
              defaults) %} (varargs, kwargs, caller), {% call [(args)]
              macro(...) %}, {% filter f | g %}, {% with a = .. %},
              {% print %}, {% raw %}, comments, and whitespace control with
              "-" ("+" accepted)
  loop        index, index0, revindex, revindex0, first, last, length,
              depth, depth0, previtem, nextitem, cycle(...), changed(...)
  globals     range, dict, namespace, cycler, joiner
  expressions jinja2's grammar and precedence: literals (adjacent strings
              join), + - * / // % ** ~, chained comparisons, in / not in,
              and / or / not, x if c [else y], is [not] TEST [arg], filters
              with arguments, calls with keyword, *args and **kwargs,
              .attr, .0, [key], [a:b:c]; any method of a value is callable
              (the environment is not sandboxed)
  filters     every builtin filter of jinja2 3.1 but `urlize` (which reads
              the environment's policies)
  tests       every builtin test of jinja2 3.1

Semantics are jinja2's defaults: the environment's getattr / getitem
fallbacks; `Undefined` (prints empty, is falsy and iterates empty; an
attribute or item of it, arithmetic on it or calling it raises
`UndefinedError`); scopes as jinja2 keeps them (a `{% set %}` in a loop body
lives for one iteration, in an `if` it reaches the enclosing scope, a macro
sees the names of the scope it was defined in, late-bound, and not its
caller's loop variables; `namespace()` carries values out); `Markup` as
markupsafe defines it (`tojson`, `safe`, `escape` return it and `markup +
str` escapes the str) with autoescape off, so `~` and `{{ }}` print plain
strings; newlines in the template normalized to "\\n" and one trailing
newline dropped; an unknown filter or test is refused at parse time unless
it sits directly in an `if` or a conditional expression, where jinja2 defers
the error to the call.

A template outside this grammar raises `TemplateSyntaxError` when it is
parsed: jinja2's own syntax errors, unknown tags (`{% generation %}`, the
extensions' tags), `{% autoescape %}`, the tags that need a loader or
inheritance (`include`, `import`, `from`, `extends`, `block`), and attribute
names that start with "_" (which a plain jinja2 environment would read; at
render time a key or `attr` name starting with "_" never falls back to a
Python attribute). `lipsum` is not provided. An error while rendering raises
a `TemplateError`.
"""

from __future__ import annotations

import html
import json
import math
import operator
import random as _random
import re
import string as _string
import textwrap
from collections import abc
from itertools import chain, groupby
from numbers import Number
from pprint import pformat
from typing import Callable, Optional
from urllib.parse import quote_from_bytes


class TemplateSyntaxError(ValueError):
    """A template outside the grammar this renderer implements."""


class TemplateError(Exception):
    """An error while rendering (jinja2 raises one of its own there)."""


class UndefinedError(TemplateError):
    """An undefined value was used where jinja2 refuses one."""


_MISSING = object()


class Undefined:
    """jinja2's default Undefined."""

    __slots__ = ("_name", "_obj", "_hint")

    def __init__(self, name=None, obj=_MISSING, hint: Optional[str] = None
                 ) -> None:
        self._name = name
        self._obj = obj
        self._hint = hint

    def _fail(self, *args, **kwargs):
        if self._hint:
            raise UndefinedError(self._hint)
        if self._obj is _MISSING:
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


# -- Markup (markupsafe's semantics) -------------------------------------------------


def escape(value) -> "Markup":
    """markupsafe.escape: HTML-escape a value's string into Markup; a value
    with `__html__` is taken as already safe."""
    if hasattr(value, "__html__"):
        return Markup(value.__html__())
    return Markup(str(value).replace("&", "&amp;").replace(">", "&gt;")
                  .replace("<", "&lt;").replace("'", "&#39;")
                  .replace('"', "&#34;"))


def _soft_str(value) -> str:
    return value if isinstance(value, str) else str(value)


class _EscapeHelper:
    """A `%` argument of Markup: escaped where it turns into a string."""

    __slots__ = ("obj",)

    def __init__(self, obj) -> None:
        self.obj = obj

    def __getitem__(self, key):
        return _EscapeHelper(self.obj[key])

    def __str__(self) -> str:
        return str(escape(self.obj))

    def __repr__(self) -> str:
        return str(escape(repr(self.obj)))

    def __int__(self) -> int:
        return int(self.obj)

    def __float__(self) -> float:
        return float(self.obj)


class _EscapeFormatter(_string.Formatter):
    def format_field(self, value, format_spec):
        if hasattr(value, "__html_format__"):
            rv = value.__html_format__(format_spec)
        elif hasattr(value, "__html__"):
            if format_spec:
                raise ValueError(
                    f"format specifier {format_spec!r} given for "
                    f"{type(value).__name__}, which defines __html__ but "
                    "not __html_format__")
            rv = value.__html__()
        else:
            rv = super().format_field(value, str(format_spec))
        return str(escape(rv))


def _escape_args(fn):
    def wrapped(self, *args, **kwargs):
        args = [escape(a) if isinstance(a, str) or hasattr(a, "__html__")
                else a for a in args]
        kwargs = {k: (escape(v) if isinstance(v, str)
                      or hasattr(v, "__html__") else v)
                  for k, v in kwargs.items()}
        return self.__class__(fn(self, *args, **kwargs))
    wrapped.__name__ = fn.__name__
    return wrapped


class Markup(str):
    """A string known to be safe HTML (markupsafe.Markup): concatenation,
    `%`, `format` and `join` escape what they take in."""

    __slots__ = ()

    def __new__(cls, base="", encoding=None, errors="strict"):
        if hasattr(base, "__html__"):
            base = base.__html__()
        if encoding is None:
            return super().__new__(cls, base)
        return super().__new__(cls, base, encoding, errors)

    def __html__(self) -> "Markup":
        return self

    def __add__(self, other):
        if isinstance(other, str) or hasattr(other, "__html__"):
            return self.__class__(super().__add__(self.escape(other)))
        return NotImplemented

    def __radd__(self, other):
        if isinstance(other, str) or hasattr(other, "__html__"):
            return self.escape(other).__add__(self)
        return NotImplemented

    def __mul__(self, num):
        if isinstance(num, int):
            return self.__class__(super().__mul__(num))
        return NotImplemented

    __rmul__ = __mul__

    def __mod__(self, arg):
        if isinstance(arg, tuple):
            arg = tuple(_EscapeHelper(x) for x in arg)
        elif hasattr(type(arg), "__getitem__") and not isinstance(arg, str):
            arg = _EscapeHelper(arg)
        else:
            arg = (_EscapeHelper(arg),)
        return self.__class__(super().__mod__(arg))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({super().__repr__()})"

    def join(self, seq) -> "Markup":
        return self.__class__(super().join(map(self.escape, seq)))

    def split(self, sep=None, maxsplit=-1) -> list:
        return [self.__class__(v) for v in super().split(sep, maxsplit)]

    def rsplit(self, sep=None, maxsplit=-1) -> list:
        return [self.__class__(v) for v in super().rsplit(sep, maxsplit)]

    def splitlines(self, keepends=False) -> list:
        return [self.__class__(v) for v in super().splitlines(keepends)]

    def partition(self, sep) -> tuple:
        left, sep, right = super().partition(self.escape(sep))
        cls = self.__class__
        return cls(left), cls(sep), cls(right)

    def rpartition(self, sep) -> tuple:
        left, sep, right = super().rpartition(self.escape(sep))
        cls = self.__class__
        return cls(left), cls(sep), cls(right)

    def format(self, *args, **kwargs) -> "Markup":
        return self.__class__(_EscapeFormatter().vformat(self, args, kwargs))

    def format_map(self, mapping) -> "Markup":
        return self.__class__(_EscapeFormatter().vformat(self, (), mapping))

    def __html_format__(self, format_spec) -> "Markup":
        if format_spec:
            raise ValueError("Unsupported format specification for Markup.")
        return self

    def unescape(self) -> str:
        return html.unescape(str(self))

    def striptags(self) -> str:
        value = str(self)
        while (start := value.find("<!--")) != -1:
            end = value.find("-->", start)
            if end == -1:
                break
            value = value[:start] + value[end + 3:]
        while (start := value.find("<")) != -1:
            end = value.find(">", start)
            if end == -1:
                break
            value = value[:start] + value[end + 1:]
        return self.__class__(" ".join(value.split())).unescape()

    @classmethod
    def escape(cls, value) -> "Markup":
        rv = escape(value)
        return rv if rv.__class__ is cls else cls(rv)

    __getitem__ = _escape_args(str.__getitem__)
    capitalize = _escape_args(str.capitalize)
    title = _escape_args(str.title)
    lower = _escape_args(str.lower)
    upper = _escape_args(str.upper)
    replace = _escape_args(str.replace)
    ljust = _escape_args(str.ljust)
    rjust = _escape_args(str.rjust)
    lstrip = _escape_args(str.lstrip)
    rstrip = _escape_args(str.rstrip)
    center = _escape_args(str.center)
    strip = _escape_args(str.strip)
    translate = _escape_args(str.translate)
    expandtabs = _escape_args(str.expandtabs)
    swapcase = _escape_args(str.swapcase)
    zfill = _escape_args(str.zfill)
    casefold = _escape_args(str.casefold)
    removeprefix = _escape_args(str.removeprefix)
    removesuffix = _escape_args(str.removesuffix)


# -- runtime objects -------------------------------------------------------------


class Namespace:
    """jinja2's namespace(): attributes settable with {% set ns.a = .. %}."""

    def __init__(self, *args, **kwargs) -> None:
        object.__setattr__(self, "_attrs", dict(*args, **kwargs))

    def __getattr__(self, name: str):
        try:
            return object.__getattribute__(self, "_attrs")[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setitem__(self, name: str, value) -> None:
        object.__getattribute__(self, "_attrs")[name] = value

    def __repr__(self) -> str:
        return f"<Namespace {object.__getattribute__(self, '_attrs')!r}>"


class Cycler:
    """jinja2's cycler(*items)."""

    def __init__(self, *items) -> None:
        if not items:
            raise RuntimeError("at least one item has to be provided")
        self.items = items
        self.pos = 0

    def reset(self) -> None:
        self.pos = 0

    @property
    def current(self):
        return self.items[self.pos]

    def next(self):
        rv = self.current
        self.pos = (self.pos + 1) % len(self.items)
        return rv

    __next__ = next


class Joiner:
    """jinja2's joiner(sep): "" the first call, `sep` after."""

    def __init__(self, sep: str = ", ") -> None:
        self.sep = sep
        self.used = False

    def __call__(self) -> str:
        if not self.used:
            self.used = True
            return ""
        return self.sep


class LoopContext:
    """The `loop` of a for body (one object for the whole loop, moved on
    each iteration, as jinja2's)."""

    def __init__(self, items: list, depth0: int = 0,
                 recurse: Optional[Callable] = None) -> None:
        self._items = items
        self.length = len(items)
        self.depth0 = depth0
        self.depth = depth0 + 1
        self._recurse = recurse
        self._last_changed = _MISSING
        self.index0 = -1

    def _at(self, i: int) -> None:
        self.index0 = i

    @property
    def index(self) -> int:
        return self.index0 + 1

    @property
    def revindex(self) -> int:
        return self.length - self.index0

    @property
    def revindex0(self) -> int:
        return self.length - self.index

    @property
    def first(self) -> bool:
        return self.index0 == 0

    @property
    def last(self) -> bool:
        return self.index0 == self.length - 1

    @property
    def previtem(self):
        if self.index0 == 0:
            return Undefined(hint="there is no previous item")
        return self._items[self.index0 - 1]

    @property
    def nextitem(self):
        if self.index0 >= self.length - 1:
            return Undefined(hint="there is no next item")
        return self._items[self.index0 + 1]

    def cycle(self, *args):
        if not args:
            raise TypeError("no items for cycling given")
        return args[self.index0 % len(args)]

    def changed(self, *value) -> bool:
        if self._last_changed != value:
            self._last_changed = value
            return True
        return False

    def __call__(self, iterable):
        if self._recurse is None:
            raise TypeError(
                "The loop must be marked as 'recursive' to be called "
                "recursively.")
        return self._recurse(iterable, self.depth)

    def __repr__(self) -> str:
        return f"<LoopContext {self.index}/{self.length}>"


class Macro:
    """A `{% macro %}` (or a `{% call %}` body, named "caller"): called, it
    renders its body in a scope whose parent is the one it was defined in,
    with jinja2's argument rules."""

    def __init__(self, name: str, arguments: tuple, defaults: list,
                 body: list, scope: "_Scope", catch_kwargs: bool,
                 catch_varargs: bool, caller: bool) -> None:
        self.name = name
        self.arguments = arguments
        self._defaults = defaults  # closures, for the last len() arguments
        self._body = body
        self._scope = scope
        self.catch_kwargs = catch_kwargs
        self.catch_varargs = catch_varargs
        self.caller = caller

    def __call__(self, *args, **kwargs) -> str:
        n = len(self.arguments)
        values = list(args[:n])
        found_caller = False
        if len(values) != n:
            for name in self.arguments[len(values):]:
                values.append(kwargs.pop(name, _MISSING))
                found_caller = found_caller or name == "caller"
        scope = _Scope(self._scope)
        first_default = n - len(self._defaults)
        for i, (name, value) in enumerate(zip(self.arguments, values)):
            if value is _MISSING:
                value = (self._defaults[i - first_default](scope)
                         if i >= first_default else
                         Undefined(name, hint=f"parameter {name!r} was not "
                                   "provided"))
            scope.vars[name] = value
        if self.caller and not found_caller:
            caller = kwargs.pop("caller", None)
            scope.vars["caller"] = (Undefined("caller",
                                              hint="No caller defined")
                                    if caller is None else caller)
        if self.catch_kwargs:
            scope.vars["kwargs"] = kwargs
        elif kwargs:
            if "caller" in kwargs:
                raise TypeError(
                    f"macro {self.name!r} was invoked with two values for "
                    "the special caller argument")
            raise TypeError(f"macro {self.name!r} takes no keyword argument "
                            f"{next(iter(kwargs))!r}")
        if self.catch_varargs:
            scope.vars["varargs"] = tuple(args[n:])
        elif len(args) > n:
            raise TypeError(f"macro {self.name!r} takes not more than {n} "
                            "argument(s)")
        out: list = []
        for node in self._body:
            node(scope, out)
        return "".join(out)

    def __repr__(self) -> str:
        return f"<Macro {self.name!r}>"


# -- attribute and item access -----------------------------------------------------


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
    """jinja2's Environment.getitem (a key starting with "_" does not fall
    back to a Python attribute)."""
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str) and not key.startswith("_"):
            try:
                return getattr(obj, key)
            except AttributeError:
                pass
        return Undefined(key, obj)


def _attribute_parts(attribute) -> list:
    if attribute is None:
        return []
    if isinstance(attribute, str):
        return [int(x) if x.isdigit() else x for x in attribute.split(".")]
    return [attribute]


def _ignore_case(value):
    return value.lower() if isinstance(value, str) else value


def _attrgetter(attribute, postprocess=None, default=None) -> Callable:
    """jinja2's make_attrgetter: a dotted path of getitem steps."""
    parts = _attribute_parts(attribute)

    def get(item):
        for part in parts:
            item = _getitem(item, part)
            if default is not None and isinstance(item, Undefined):
                item = default
        return postprocess(item) if postprocess is not None else item
    return get


def _multi_attrgetter(attribute, postprocess=None) -> Callable:
    split = (attribute.split(",") if isinstance(attribute, str)
             else [attribute])
    paths = [_attribute_parts(a) for a in split]

    def get(item):
        keys = []
        for path in paths:
            value = item
            for part in path:
                value = _getitem(value, part)
            keys.append(postprocess(value) if postprocess is not None
                        else value)
        return keys
    return get


# -- filters -------------------------------------------------------------------------


def _tojson(value, indent=None) -> Markup:
    dumped = json.dumps(value, sort_keys=True, indent=indent)
    return Markup(dumped.replace("<", "\\u003c").replace(">", "\\u003e")
                  .replace("&", "\\u0026").replace("'", "\\u0027"))


def _first(seq):
    try:
        return next(iter(seq))
    except StopIteration:
        return Undefined(hint="No first item, sequence was empty.")


def _last(seq):
    try:
        return next(iter(reversed(seq)))
    except StopIteration:
        return Undefined(hint="No last item, sequence was empty.")


def _random_item(seq):
    try:
        return _random.choice(seq)
    except IndexError:
        return Undefined(hint="No random item, sequence was empty.")


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
        except (TypeError, ValueError, OverflowError):
            return default


def _float(value, default=0.0):
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


def _items(value):
    if isinstance(value, Undefined):
        return iter(())
    if not isinstance(value, abc.Mapping):
        raise TemplateError("Can only get item pairs from a mapping.")
    return iter(value.items())


def _join(value, d="", attribute=None) -> str:
    if attribute is not None:
        value = map(_attrgetter(attribute), value)
    return str(d).join(map(str, value))


def _replace(s, old, new, count=None) -> str:
    return str(s).replace(str(old), str(new), -1 if count is None else count)


def _format(value, *args, **kwargs):
    if args and kwargs:
        raise TemplateError("can't handle positional and keyword arguments "
                            "at the same time")
    return _soft_str(value) % (kwargs or args)


def _capitalize(s):
    return _soft_str(s).capitalize()


_WORD_BEGINNING = re.compile(r"([-\s({\[<]+)")


def _title(s) -> str:
    return "".join(item[0].upper() + item[1:].lower()
                   for item in _WORD_BEGINNING.split(_soft_str(s)) if item)


def _center(value, width=80):
    return _soft_str(value).center(width)


def _indent(s, width=4, first=False, blank=False):
    indention = width if isinstance(width, str) else " " * width
    newline = "\n"
    if isinstance(s, Markup):
        indention = Markup(indention)
        newline = Markup(newline)
    s += newline  # so that splitlines keeps a trailing empty line
    if blank:
        rv = (newline + indention).join(s.splitlines())
    else:
        lines = s.splitlines()
        rv = lines.pop(0)
        if lines:
            rv += newline + newline.join(
                indention + line if line else line for line in lines)
    if first:
        rv = indention + rv
    return rv


def _round(value, precision=0, method="common"):
    if method not in ("common", "ceil", "floor"):
        raise TemplateError("method must be common, ceil or floor")
    if method == "common":
        return round(value, precision)
    fn = getattr(math, method)
    return fn(value * (10 ** precision)) / (10 ** precision)


def _reverse(value):
    if isinstance(value, str):
        return value[::-1]
    try:
        return reversed(value)
    except TypeError:
        try:
            rv = list(value)
            rv.reverse()
            return rv
        except TypeError as exc:
            raise TemplateError("argument must be iterable") from exc


def _sort(value, reverse=False, case_sensitive=False, attribute=None):
    key = _multi_attrgetter(attribute,
                            None if case_sensitive else _ignore_case)
    return sorted(value, key=key, reverse=reverse)


def _dictsort(value, case_sensitive=False, by="key", reverse=False):
    if by == "key":
        pos = 0
    elif by == "value":
        pos = 1
    else:
        raise TemplateError('You can only sort by either "key" or "value"')

    def key(item):
        v = item[pos]
        return v if case_sensitive else _ignore_case(v)
    return sorted(value.items(), key=key, reverse=reverse)


def _unique(value, case_sensitive=False, attribute=None):
    get = _attrgetter(attribute, None if case_sensitive else _ignore_case)
    seen = set()
    for item in value:
        key = get(item)
        if key not in seen:
            seen.add(key)
            yield item


def _min_or_max(value, fn, case_sensitive, attribute):
    it = iter(value)
    try:
        first = next(it)
    except StopIteration:
        return Undefined(hint="No aggregated item, sequence was empty.")
    key = _attrgetter(attribute, None if case_sensitive else _ignore_case)
    return fn(chain([first], it), key=key)


def _min(value, case_sensitive=False, attribute=None):
    return _min_or_max(value, min, case_sensitive, attribute)


def _max(value, case_sensitive=False, attribute=None):
    return _min_or_max(value, max, case_sensitive, attribute)


def _sum(iterable, attribute=None, start=0):
    if attribute is not None:
        iterable = map(_attrgetter(attribute), iterable)
    return sum(iterable, start)


def _batch(value, linecount, fill_with=None):
    tmp: list = []
    for item in value:
        if len(tmp) == linecount:
            yield tmp
            tmp = []
        tmp.append(item)
    if tmp:
        if fill_with is not None and len(tmp) < linecount:
            tmp += [fill_with] * (linecount - len(tmp))
        yield tmp


def _slice(value, slices, fill_with=None):
    seq = list(value)
    per, extra = divmod(len(seq), slices)
    offset = 0
    for n in range(slices):
        start = offset + n * per
        if n < extra:
            offset += 1
        end = offset + (n + 1) * per
        tmp = seq[start:end]
        if fill_with is not None and n >= extra:
            tmp.append(fill_with)
        yield tmp


class _GroupTuple(tuple):
    """groupby's (grouper, list) pairs."""

    def __new__(cls, grouper, items):
        return super().__new__(cls, (grouper, items))

    @property
    def grouper(self):
        return self[0]

    @property
    def list(self):
        return self[1]


def _groupby(value, attribute, default=None, case_sensitive=False):
    key = _attrgetter(attribute, None if case_sensitive else _ignore_case,
                      default)
    out = [_GroupTuple(k, list(items))
           for k, items in groupby(sorted(value, key=key), key)]
    if not case_sensitive:
        real = _attrgetter(attribute, default=default)
        out = [_GroupTuple(real(items[0]), items) for _, items in out]
    return out


def _truncate(s, length=255, killwords=False, end="...", leeway=None):
    leeway = 5 if leeway is None else leeway
    if length < len(end):
        raise TemplateError(f"expected length >= {len(end)}, got {length}")
    if leeway < 0:
        raise TemplateError(f"expected leeway >= 0, got {leeway}")
    if len(s) <= length + leeway:
        return s
    if killwords:
        return s[:length - len(end)] + end
    return s[:length - len(end)].rsplit(" ", 1)[0] + end


_WORD = re.compile(r"\w+")


def _wordcount(s) -> int:
    return len(_WORD.findall(_soft_str(s)))


def _wordwrap(s, width=79, break_long_words=True, wrapstring=None,
              break_on_hyphens=True) -> str:
    wrapstring = "\n" if wrapstring is None else wrapstring
    return wrapstring.join(
        wrapstring.join(textwrap.wrap(
            line, width=width, expand_tabs=False, replace_whitespace=False,
            break_long_words=break_long_words,
            break_on_hyphens=break_on_hyphens))
        for line in s.splitlines())


def _url_quote(obj, for_qs=False) -> str:
    if not isinstance(obj, bytes):
        obj = (obj if isinstance(obj, str) else str(obj)).encode("utf-8")
    rv = quote_from_bytes(obj, b"" if for_qs else b"/")
    return rv.replace("%20", "+") if for_qs else rv


def _urlencode(value) -> str:
    if isinstance(value, str) or not isinstance(value, abc.Iterable):
        return _url_quote(value)
    items = value.items() if isinstance(value, dict) else iter(value)
    return "&".join(f"{_url_quote(k, True)}={_url_quote(v, True)}"
                    for k, v in items)


def _filesizeformat(value, binary=False) -> str:
    size = float(value)
    base = 1024 if binary else 1000
    prefixes = (["KiB", "MiB", "GiB", "TiB", "PiB", "EiB", "ZiB", "YiB"]
                if binary else
                ["kB", "MB", "GB", "TB", "PB", "EB", "ZB", "YB"])
    if size == 1:
        return "1 Byte"
    if size < base:
        return f"{int(size)} Bytes"
    for i, prefix in enumerate(prefixes):
        unit = base ** (i + 2)
        if size < unit:
            break
    return f"{base * size / unit:.1f} {prefix}"


_ATTR_KEY_INVALID = re.compile(r"[\s/>=]")


def _xmlattr(d, autospace=True) -> Markup:
    items = []
    for key, value in d.items():
        if value is None or isinstance(value, Undefined):
            continue
        if _ATTR_KEY_INVALID.search(key) is not None:
            raise TemplateError(f"Invalid character in attribute name: "
                                f"{key!r}")
        items.append(f'{escape(key)}="{escape(value)}"')
    rv = " ".join(items)
    if autospace and rv:
        rv = " " + rv
    return Markup(rv)


def _forceescape(value) -> Markup:
    if hasattr(value, "__html__"):
        value = value.__html__()
    return escape(str(value))


def _attr(obj, name):
    name = str(name)
    if not name.startswith("_"):
        try:
            return getattr(obj, name)
        except AttributeError:
            pass
    return Undefined(name, obj)


def _select_or_reject(value, args, kwargs, keep: bool, lookup_attr: bool):
    if lookup_attr:
        get = _attrgetter(args[0])
        args = args[1:]
    else:
        get = None
    if args:
        name, args = args[0], args[1:]
        test = TESTS.get(name)
        if test is None:
            raise TemplateError(f"No test named {name!r}.")

        def check(item):
            return test(item, *args, **kwargs)
    else:
        check = bool
    for item in value or ():
        target = get(item) if get is not None else item
        if bool(check(target)) == keep:
            yield item


def _select(value, *args, **kwargs):
    return _select_or_reject(value, args, kwargs, True, False)


def _reject(value, *args, **kwargs):
    return _select_or_reject(value, args, kwargs, False, False)


def _selectattr(value, *args, **kwargs):
    return _select_or_reject(value, args, kwargs, True, True)


def _rejectattr(value, *args, **kwargs):
    return _select_or_reject(value, args, kwargs, False, True)


def _map(value, *args, **kwargs):
    if "attribute" in kwargs:
        attribute = kwargs.pop("attribute")
        default = kwargs.pop("default", None)
        if kwargs:
            raise TemplateError(
                f"Unexpected keyword argument {next(iter(kwargs))!r}")
        fn = _attrgetter(attribute, default=default)
    else:
        if not args:
            raise TemplateError("map requires a filter argument")
        name, args = args[0], args[1:]
        flt = FILTERS.get(name)
        if flt is None:
            raise TemplateError(f"No filter named {name!r}.")

        def fn(item):
            return flt(item, *args, **kwargs)
    if value:
        for item in value:
            yield fn(item)


FILTERS: dict[str, Callable] = {
    "abs": abs,
    "attr": _attr,
    "batch": _batch,
    "capitalize": _capitalize,
    "center": _center,
    "count": len,
    "d": _default,
    "default": _default,
    "dictsort": _dictsort,
    "e": escape,
    "escape": escape,
    "filesizeformat": _filesizeformat,
    "first": _first,
    "float": _float,
    "forceescape": _forceescape,
    "format": _format,
    "groupby": _groupby,
    "indent": _indent,
    "int": _int,
    "items": _items,
    "join": _join,
    "last": _last,
    "length": len,
    "list": list,
    "lower": lambda s: _soft_str(s).lower(),
    "map": _map,
    "max": _max,
    "min": _min,
    "pprint": pformat,
    "random": _random_item,
    "reject": _reject,
    "rejectattr": _rejectattr,
    "replace": _replace,
    "reverse": _reverse,
    "round": _round,
    "safe": Markup,
    "select": _select,
    "selectattr": _selectattr,
    "slice": _slice,
    "sort": _sort,
    "string": _soft_str,
    "striptags": lambda v: Markup(str(v)).striptags(),
    "sum": _sum,
    "title": _title,
    "tojson": _tojson,
    "trim": lambda s, chars=None: _soft_str(s).strip(chars),
    "truncate": _truncate,
    "unique": _unique,
    "upper": lambda s: _soft_str(s).upper(),
    "urlencode": _urlencode,
    "wordcount": _wordcount,
    "wordwrap": _wordwrap,
    "xmlattr": _xmlattr,
}


# -- tests ---------------------------------------------------------------------------


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
    "odd": lambda v: v % 2 == 1,
    "even": lambda v: v % 2 == 0,
    "divisibleby": lambda v, num: v % num == 0,
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "filter": lambda v: v in FILTERS,
    "test": lambda v: v in TESTS,
    "none": lambda v: v is None,
    "boolean": lambda v: v is True or v is False,
    "false": lambda v: v is False,
    "true": lambda v: v is True,
    "integer": lambda v: isinstance(v, int) and v is not True
    and v is not False,
    "float": lambda v: isinstance(v, float),
    "lower": lambda v: str(v).islower(),
    "upper": lambda v: str(v).isupper(),
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, abc.Mapping),
    "number": lambda v: isinstance(v, Number),
    "sequence": _is_sequence,
    "iterable": _is_iterable,
    "callable": callable,
    "sameas": lambda v, other: v is other,
    "escaped": lambda v: hasattr(v, "__html__"),
    "in": lambda v, seq: v in seq,
    "==": operator.eq, "eq": operator.eq, "equalto": operator.eq,
    "!=": operator.ne, "ne": operator.ne,
    ">": operator.gt, "gt": operator.gt, "greaterthan": operator.gt,
    ">=": operator.ge, "ge": operator.ge,
    "<": operator.lt, "lt": operator.lt, "lessthan": operator.lt,
    "<=": operator.le, "le": operator.le,
}

GLOBALS: dict = {"range": range, "dict": dict, "namespace": Namespace,
                 "cycler": Cycler, "joiner": Joiner}


# -- lexer ---------------------------------------------------------------------------

_NEWLINE = re.compile(r"(\r\n|\r|\n)")
_OPEN = re.compile(r"\{\{|\{%|\{#")
_RAW_BEGIN = re.compile(r"\{%([-+]?)\s*raw\s*(-%\}\s*|%\})")
_RAW_END = re.compile(r"\{%([-+]?)\s*endraw\s*(\+%\}|-%\}\s*|%\})")
_COMMENT_END = re.compile(r"(\+#\}|-#\}\s*|#\})")
_WS = re.compile(r"\s+")
_NAME = re.compile(r"[^\W\d]\w*")
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?e[+\-]?(\d+_)*\d+"
                    r"|\.(\d+_)*\d+)", re.I)
_INT = re.compile(r"(0b(_?[0-1])+|0o(_?[0-7])+|0x(_?[\da-f])+|[1-9](_?\d)*"
                  r"|0(_?0)*)", re.I)
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'"
                     r'|"([^"\\]*(?:\\.[^"\\]*)*)")', re.S)
_OPERATORS = ("//", "**", "==", "!=", "<=", ">=", "+", "-", "/", "*", "%",
              "~", "<", ">", "=", ".", ":", "|", ",", ";", "(", ")", "[",
              "]", "{", "}")
_BRACKETS = {"(": ")", "[": "]", "{": "}"}
# tag end: (pattern, the token it closes with)
_VAR_END = re.compile(r"-\}\}\s*|\}\}")
_BLOCK_END = re.compile(r"-%\}\s*|\+%\}|%\}")


def _lex(source: str) -> list:
    """jinja2's default lexer: a flat list of (type, value) tokens with type
    in data, var_begin, var_end, block_begin, block_end, name, string,
    integer, float, op; then eof."""
    lines = _NEWLINE.split(source)[::2]
    if lines and lines[-1] == "":
        del lines[-1]  # keep_trailing_newline=False
    source = "\n".join(lines)
    out: list = []
    pos, n = 0, len(source)
    lstrip = False  # the previous tag ended with "-": strip leading space

    def data(text: str, rstrip: bool) -> None:
        if lstrip:
            text = text.lstrip()
        if rstrip:
            text = text.rstrip()
        if text:
            out.append(("data", text))

    while pos < n:
        m = _OPEN.search(source, pos)
        if m is None:
            data(source[pos:], False)
            break
        start = m.start()
        modifier = source[m.end():m.end() + 1]
        data(source[pos:start], modifier == "-")
        lstrip = False
        if m.group(0) == "{%":
            raw = _RAW_BEGIN.match(source, start)
            if raw is not None:
                end = _RAW_END.search(source, raw.end())
                if end is None:
                    raise TemplateSyntaxError("Missing end of raw directive")
                text = source[raw.end():end.start()]
                if end.group(1) == "-":
                    text = text.rstrip()
                if text:
                    out.append(("data", text))
                lstrip = end.group(2).startswith("-")
                pos = end.end()
                continue
        pos = m.end() + (1 if modifier in ("-", "+") else 0)
        if m.group(0) == "{#":
            end = _COMMENT_END.search(source, pos)
            if end is None:
                raise TemplateSyntaxError("Missing end of comment tag")
            lstrip = end.group(1).startswith("-")
            pos = end.end()
            continue
        is_var = m.group(0) == "{{"
        out.append(("var_begin" if is_var else "block_begin", None))
        closer = _VAR_END if is_var else _BLOCK_END
        balance: list = []
        while True:
            ws = _WS.match(source, pos)
            if ws:
                pos = ws.end()
            if pos >= n:
                raise TemplateSyntaxError(
                    f"unexpected end of template, expected end of "
                    f"{'print statement' if is_var else 'statement block'}")
            if not balance:
                end = closer.match(source, pos)
                if end is not None:
                    out.append(("var_end" if is_var else "block_end", None))
                    lstrip = end.group(0).startswith("-")
                    pos = end.end()
                    break
            tok = _FLOAT.match(source, pos)
            if tok:
                out.append(("float", float(tok.group(0).replace("_", ""))))
                pos = tok.end()
                continue
            tok = _INT.match(source, pos)
            if tok:
                out.append(("integer",
                            int(tok.group(0).replace("_", ""), 0)))
                pos = tok.end()
                continue
            tok = _NAME.match(source, pos)
            if tok:
                out.append(("name", tok.group(0)))
                pos = tok.end()
                continue
            tok = _STRING.match(source, pos)
            if tok:
                out.append(("string", tok.group(0)[1:-1].encode(
                    "ascii", "backslashreplace").decode("unicode-escape")))
                pos = tok.end()
                continue
            for op in _OPERATORS:
                if source.startswith(op, pos):
                    break
            else:
                raise TemplateSyntaxError(
                    f"unexpected char {source[pos]!r}")
            if op in _BRACKETS:
                balance.append(_BRACKETS[op])
            elif op in (")", "]", "}"):
                if not balance:
                    raise TemplateSyntaxError(f"unexpected '{op}'")
                if balance.pop() != op:
                    raise TemplateSyntaxError(f"unexpected '{op}'")
            out.append(("op", op))
            pos += len(op)
    out.append(("eof", None))
    return out


# -- tree ----------------------------------------------------------------------------


class _Node:
    """A template tree node; `fields` name its children."""

    fields: tuple = ()

    def children(self):
        stack = [getattr(self, name) for name in reversed(self.fields)]
        while stack:
            value = stack.pop()
            if isinstance(value, _Node):
                yield value
            elif isinstance(value, (list, tuple)):
                stack.extend(reversed(value))


def _node(name: str, fields: str):
    names = tuple(fields.split())

    def __init__(self, *args):
        for key, value in zip(names, args):
            setattr(self, key, value)
    return type(name, (_Node,), {"fields": names, "__init__": __init__})


Const = _node("Const", "value")
Name = _node("Name", "name ctx")
TupleLit = _node("TupleLit", "items")
ListLit = _node("ListLit", "items")
DictLit = _node("DictLit", "pairs")
Getattr = _node("Getattr", "node attr")
Getitem = _node("Getitem", "node arg")
SliceLit = _node("SliceLit", "start stop step")
Call = _node("Call", "node args kwargs dyn_args dyn_kwargs")
Filter = _node("Filter", "node name args kwargs dyn_args dyn_kwargs")
Test = _node("Test", "node name args kwargs dyn_args dyn_kwargs")
CondExpr = _node("CondExpr", "test expr1 expr2")
BinOp = _node("BinOp", "op left right")
Concat = _node("Concat", "nodes")
Compare = _node("Compare", "expr ops")
And = _node("And", "left right")
Or = _node("Or", "left right")
Not = _node("Not", "node")
Neg = _node("Neg", "node")
Pos = _node("Pos", "node")
NSRef = _node("NSRef", "name attr")
TemplateData = _node("TemplateData", "text")
Output = _node("Output", "nodes")
If = _node("If", "test body elifs else_")
For = _node("For", "target iter body else_ test recursive")
MacroDef = _node("MacroDef", "name args defaults body")
CallBlock = _node("CallBlock", "call args defaults body")
FilterBlock = _node("FilterBlock", "body filter")
With = _node("With", "targets values body")
Assign = _node("Assign", "target node")
AssignBlock = _node("AssignBlock", "target filter body")

_CONSTANT_NAMES = {"true": True, "True": True, "false": False,
                   "False": False, "none": None, "None": None}
_COMPARE_OPS = ("==", "!=", "<", "<=", ">", ">=")
_STATEMENT_TAGS = ("for", "if", "print", "macro", "set", "with", "call",
                   "filter")
_REFUSED_TAGS = {
    "include": "needs a template loader",
    "import": "needs a template loader",
    "from": "needs a template loader",
    "extends": "needs a template loader",
    "block": "template inheritance is not implemented",
    "autoescape": "autoescape blocks are not implemented",
}


def _walk(node):
    yield node
    for child in node.children():
        yield from _walk(child)


def _undeclared(body: list, names: tuple) -> set:
    """jinja2's find_undeclared: which of `names` the body loads before it
    stores them."""
    wanted, found = set(names), set()
    for top in body:
        for node in _walk(top):
            if isinstance(node, Name) and node.name in wanted:
                if node.ctx == "load":
                    found.add(node.name)
                else:
                    wanted.discard(node.name)
    return found


class _Parser:
    def __init__(self, tokens: list) -> None:
        self.tokens = tokens
        self.i = 0

    # token stream ------------------------------------------------------

    @property
    def cur(self):
        return self.tokens[self.i]

    def look(self, offset: int = 1):
        j = min(self.i + offset, len(self.tokens) - 1)
        return self.tokens[j]

    def next(self):
        tok = self.tokens[self.i]
        if tok[0] != "eof":
            self.i += 1
        return tok

    def at(self, kind: str, value=None) -> bool:
        k, v = self.tokens[self.i]
        return k == kind and (value is None or v == value)

    def at_op(self, value: str) -> bool:
        return self.at("op", value)

    def skip_if(self, kind: str, value=None) -> bool:
        if self.at(kind, value):
            self.next()
            return True
        return False

    def expect(self, kind: str, value=None):
        if not self.at(kind, value):
            got = self.cur[1] if self.cur[1] is not None else self.cur[0]
            raise TemplateSyntaxError(
                f"expected {value if value is not None else kind}, got "
                f"{got!r}")
        return self.next()[1]

    # templates ---------------------------------------------------------

    def subparse(self, end_tags: Optional[tuple] = None) -> list:
        body: list = []
        data: list = []

        def flush():
            if data:
                body.append(Output(list(data)))
                data.clear()
        while not self.at("eof"):
            kind = self.cur[0]
            if kind == "data":
                data.append(TemplateData(self.next()[1]))
            elif kind == "var_begin":
                self.next()
                data.append(self.parse_tuple())
                self.expect("var_end")
            elif kind == "block_begin":
                flush()
                self.next()
                if end_tags and self.at("name") and self.cur[1] in end_tags:
                    return body
                node = self.parse_statement()
                if isinstance(node, list):
                    body.extend(node)
                else:
                    body.append(node)
                self.expect("block_end")
            else:
                raise TemplateSyntaxError(f"unexpected {kind}")
        flush()
        if end_tags:
            raise TemplateSyntaxError(
                "Unexpected end of template. Jinja was looking for the "
                f"following tags: {' or '.join(map(repr, end_tags))}.")
        return body

    def parse_statements(self, end_tags: tuple,
                         drop_needle: bool = False) -> list:
        self.skip_if("op", ":")
        self.expect("block_end")
        body = self.subparse(end_tags)
        if self.at("eof"):
            raise TemplateSyntaxError(f"missing {' / '.join(end_tags)}")
        if drop_needle:
            self.next()
        return body

    def parse_statement(self):
        if not self.at("name"):
            raise TemplateSyntaxError("tag name expected")
        tag = self.cur[1]
        if tag in _REFUSED_TAGS:
            raise TemplateSyntaxError(f"tag {tag!r}: {_REFUSED_TAGS[tag]}")
        if tag not in _STATEMENT_TAGS:
            raise TemplateSyntaxError(f"Encountered unknown tag {tag!r}.")
        return getattr(self, f"parse_{tag}")()

    def parse_for(self):
        self.next()
        target = self.parse_assign_target(extra_end=("in",))
        if any(isinstance(n, Name) and n.name == "loop"
               for n in _walk(target)):
            raise TemplateSyntaxError(
                "Can't assign to special loop variable in for-loop target")
        self.expect("name", "in")
        iterable = self.parse_tuple(with_condexpr=False,
                                    extra_end=("recursive",))
        test = self.parse_expression() if self.skip_if("name", "if") else None
        recursive = self.skip_if("name", "recursive")
        body = self.parse_statements(("endfor", "else"))
        else_: list = []
        if self.next()[1] == "else":
            else_ = self.parse_statements(("endfor",), drop_needle=True)
        return For(target, iterable, body, else_, test, recursive)

    def parse_if(self):
        self.next()
        test = self.parse_tuple(with_condexpr=False)
        body = self.parse_statements(("elif", "else", "endif"))
        node = If(test, body, [], [])
        while True:
            tag = self.next()[1]
            if tag == "elif":
                test = self.parse_tuple(with_condexpr=False)
                body = self.parse_statements(("elif", "else", "endif"))
                node.elifs.append((test, body))
                continue
            if tag == "else":
                node.else_ = self.parse_statements(("endif",),
                                                   drop_needle=True)
            break
        return node

    def parse_print(self):
        self.next()
        nodes = []
        while not self.at("block_end"):
            if nodes:
                self.expect("op", ",")
            nodes.append(self.parse_expression())
        return Output(nodes)

    def parse_signature(self) -> tuple:
        args, defaults = [], []
        self.expect("op", "(")
        while not self.at_op(")"):
            if args:
                self.expect("op", ",")
            arg = self.parse_assign_target(name_only=True)
            arg.ctx = "param"
            if self.skip_if("op", "="):
                defaults.append(self.parse_expression())
            elif defaults:
                raise TemplateSyntaxError(
                    "non-default argument follows default argument")
            args.append(arg)
        self.expect("op", ")")
        return args, defaults

    def parse_macro(self):
        self.next()
        name = self.parse_assign_target(name_only=True).name
        args, defaults = self.parse_signature()
        body = self.parse_statements(("endmacro",), drop_needle=True)
        return MacroDef(name, args, defaults, body)

    def parse_call(self):
        self.next()
        args, defaults = (self.parse_signature() if self.at_op("(")
                          else ([], []))
        call = self.parse_expression()
        if not isinstance(call, Call):
            raise TemplateSyntaxError("expected call")
        body = self.parse_statements(("endcall",), drop_needle=True)
        return CallBlock(call, args, defaults, body)

    def parse_filter(self):
        self.next()
        flt = self.parse_filter_chain(None, start_inline=True)
        body = self.parse_statements(("endfilter",), drop_needle=True)
        return FilterBlock(body, flt)

    def parse_with(self):
        self.next()
        targets, values = [], []
        while not self.at("block_end"):
            if targets:
                self.expect("op", ",")
            target = self.parse_assign_target()
            self.expect("op", "=")
            targets.append(target)
            values.append(self.parse_expression())
        body = self.parse_statements(("endwith",), drop_needle=True)
        return With(targets, values, body)

    def parse_set(self):
        self.next()
        target = self.parse_assign_target(with_namespace=True)
        if self.skip_if("op", "="):
            return Assign(target, self.parse_tuple())
        flt = self.parse_filter_chain(None)
        body = self.parse_statements(("endset",), drop_needle=True)
        return AssignBlock(target, flt, body)

    def parse_assign_target(self, with_tuple: bool = True,
                            name_only: bool = False, extra_end=None,
                            with_namespace: bool = False):
        if with_namespace and self.at("name") and self.look()[1] == "." \
                and self.look()[0] == "op":
            name = self.next()[1]
            self.next()
            attr = self.expect("name")
            if attr.startswith("_"):
                raise TemplateSyntaxError(f"attribute {attr!r}")
            return NSRef(name, attr)
        if name_only:
            target = Name(self.expect("name"), "store")
        else:
            target = (self.parse_tuple(simplified=True, extra_end=extra_end)
                      if with_tuple else self.parse_primary())
        for node in _walk(target):
            if isinstance(node, Name):
                node.ctx = "store"
        if not self._can_assign(target):
            raise TemplateSyntaxError(
                f"can't assign to {type(target).__name__.lower()!r}")
        return target

    @staticmethod
    def _can_assign(target) -> bool:
        if isinstance(target, Name):
            return target.name not in _CONSTANT_NAMES
        if isinstance(target, TupleLit):
            return all(_Parser._can_assign(t) for t in target.items)
        return False

    # expressions -------------------------------------------------------

    def parse_expression(self, with_condexpr: bool = True):
        return self.parse_condexpr() if with_condexpr else self.parse_or()

    def parse_condexpr(self):
        expr1 = self.parse_or()
        while self.skip_if("name", "if"):
            expr2 = self.parse_or()
            expr3 = (self.parse_condexpr() if self.skip_if("name", "else")
                     else None)
            expr1 = CondExpr(expr2, expr1, expr3)
        return expr1

    def parse_or(self):
        left = self.parse_and()
        while self.skip_if("name", "or"):
            left = Or(left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.skip_if("name", "and"):
            left = And(left, self.parse_not())
        return left

    def parse_not(self):
        if self.skip_if("name", "not"):
            return Not(self.parse_not())
        return self.parse_compare()

    def parse_compare(self):
        expr = self.parse_math1()
        ops = []
        while True:
            if self.at("op") and self.cur[1] in _COMPARE_OPS:
                op = self.next()[1]
                ops.append((op, self.parse_math1()))
            elif self.skip_if("name", "in"):
                ops.append(("in", self.parse_math1()))
            elif self.at("name", "not") and self.look() == ("name", "in"):
                self.next()
                self.next()
                ops.append(("notin", self.parse_math1()))
            else:
                break
        return Compare(expr, ops) if ops else expr

    def parse_math1(self):
        left = self.parse_concat()
        while self.at("op") and self.cur[1] in ("+", "-"):
            op = self.next()[1]
            left = BinOp(op, left, self.parse_concat())
        return left

    def parse_concat(self):
        nodes = [self.parse_math2()]
        while self.skip_if("op", "~"):
            nodes.append(self.parse_math2())
        return nodes[0] if len(nodes) == 1 else Concat(nodes)

    def parse_math2(self):
        left = self.parse_pow()
        while self.at("op") and self.cur[1] in ("*", "/", "//", "%"):
            op = self.next()[1]
            left = BinOp(op, left, self.parse_pow())
        return left

    def parse_pow(self):
        left = self.parse_unary()
        while self.skip_if("op", "**"):
            left = BinOp("**", left, self.parse_unary())
        return left

    def parse_unary(self, with_filter: bool = True):
        if self.skip_if("op", "-"):
            node = Neg(self.parse_unary(False))
        elif self.skip_if("op", "+"):
            node = Pos(self.parse_unary(False))
        else:
            node = self.parse_primary()
        node = self.parse_postfix(node)
        return self.parse_filter_expr(node) if with_filter else node

    def parse_primary(self):
        kind, value = self.cur
        if kind == "name":
            self.next()
            if value in _CONSTANT_NAMES:
                return Const(_CONSTANT_NAMES[value])
            return Name(value, "load")
        if kind == "string":
            self.next()
            parts = [value]
            while self.at("string"):
                parts.append(self.next()[1])
            return Const("".join(parts))
        if kind in ("integer", "float"):
            self.next()
            return Const(value)
        if kind == "op" and value == "(":
            self.next()
            node = self.parse_tuple(explicit_parentheses=True)
            self.expect("op", ")")
            return node
        if kind == "op" and value == "[":
            self.next()
            items = []
            while not self.at_op("]"):
                if items:
                    self.expect("op", ",")
                    if self.at_op("]"):
                        break
                items.append(self.parse_expression())
            self.expect("op", "]")
            return ListLit(items)
        if kind == "op" and value == "{":
            self.next()
            pairs = []
            while not self.at_op("}"):
                if pairs:
                    self.expect("op", ",")
                    if self.at_op("}"):
                        break
                key = self.parse_expression()
                self.expect("op", ":")
                pairs.append((key, self.parse_expression()))
            self.expect("op", "}")
            return DictLit(pairs)
        raise TemplateSyntaxError(f"unexpected {value if value else kind!r}")

    def _tuple_end(self, extra_end) -> bool:
        kind, value = self.cur
        if kind in ("var_end", "block_end", "eof") or (kind, value) == (
                "op", ")"):
            return True
        return bool(extra_end) and kind == "name" and value in extra_end

    def parse_tuple(self, simplified: bool = False,
                    with_condexpr: bool = True, extra_end=None,
                    explicit_parentheses: bool = False):
        if simplified:
            parse = self.parse_primary
        elif with_condexpr:
            parse = self.parse_expression
        else:
            def parse():
                return self.parse_expression(False)
        items = []
        is_tuple = False
        while True:
            if items:
                self.expect("op", ",")
            if self._tuple_end(extra_end):
                break
            items.append(parse())
            if self.at_op(","):
                is_tuple = True
            else:
                break
        if not is_tuple:
            if items:
                return items[0]
            if not explicit_parentheses:
                raise TemplateSyntaxError(
                    f"Expected an expression, got {self.cur[0]!r}")
        return TupleLit(items)

    def parse_postfix(self, node):
        while True:
            if self.at_op(".") or self.at_op("["):
                node = self.parse_subscript(node)
            elif self.at_op("("):
                node = self.parse_call_expr(node)
            else:
                return node

    def parse_filter_expr(self, node):
        while True:
            if self.at_op("|"):
                node = self.parse_filter_chain(node)
            elif self.at("name", "is"):
                node = self.parse_test(node)
            elif self.at_op("("):
                node = self.parse_call_expr(node)
            else:
                return node

    def parse_subscript(self, node):
        kind, value = self.next()
        if value == ".":
            akind, attr = self.next()
            if akind == "name":
                if attr.startswith("_"):
                    raise TemplateSyntaxError(
                        f"attribute {attr!r}: names starting with '_' are "
                        "not read")
                return Getattr(node, attr)
            if akind != "integer":
                raise TemplateSyntaxError("expected name or number")
            return Getitem(node, Const(attr))
        args = []
        while not self.at_op("]"):
            if args:
                self.expect("op", ",")
            args.append(self.parse_subscribed())
        self.expect("op", "]")
        return Getitem(node, args[0] if len(args) == 1 else TupleLit(args))

    def parse_subscribed(self):
        if self.skip_if("op", ":"):
            parts = [None]
        else:
            node = self.parse_expression()
            if not self.skip_if("op", ":"):
                return node
            parts = [node]
        if self.at_op(":"):
            parts.append(None)
        elif not (self.at_op("]") or self.at_op(",")):
            parts.append(self.parse_expression())
        else:
            parts.append(None)
        if self.skip_if("op", ":"):
            parts.append(None if self.at_op("]") or self.at_op(",")
                         else self.parse_expression())
        else:
            parts.append(None)
        return SliceLit(*parts)

    def parse_call_args(self) -> tuple:
        self.expect("op", "(")
        args, kwargs = [], []
        dyn_args = dyn_kwargs = None
        need_comma = False

        def ensure(ok: bool) -> None:
            if not ok:
                raise TemplateSyntaxError(
                    "invalid syntax for function call expression")
        while not self.at_op(")"):
            if need_comma:
                self.expect("op", ",")
                if self.at_op(")"):
                    break
            if self.skip_if("op", "*"):
                ensure(dyn_args is None and dyn_kwargs is None)
                dyn_args = self.parse_expression()
            elif self.skip_if("op", "**"):
                ensure(dyn_kwargs is None)
                dyn_kwargs = self.parse_expression()
            elif self.at("name") and self.look() == ("op", "="):
                ensure(dyn_kwargs is None)
                key = self.next()[1]
                self.next()
                kwargs.append((key, self.parse_expression()))
            else:
                ensure(dyn_args is None and dyn_kwargs is None
                       and not kwargs)
                args.append(self.parse_expression())
            need_comma = True
        self.expect("op", ")")
        return args, kwargs, dyn_args, dyn_kwargs

    def parse_call_expr(self, node):
        return Call(node, *self.parse_call_args())

    def _dotted_name(self) -> str:
        name = self.expect("name")
        while self.at_op("."):
            self.next()
            name += "." + self.expect("name")
        return name

    def parse_filter_chain(self, node, start_inline: bool = False):
        while self.at_op("|") or start_inline:
            if not start_inline:
                self.next()
            name = self._dotted_name()
            call = (self.parse_call_args() if self.at_op("(")
                    else ([], [], None, None))
            node = Filter(node, name, *call)
            start_inline = False
        return node

    def parse_test(self, node):
        self.next()
        negated = self.skip_if("name", "not")
        name = self._dotted_name()
        kwargs, dyn_args, dyn_kwargs = [], None, None
        if self.at_op("("):
            args, kwargs, dyn_args, dyn_kwargs = self.parse_call_args()
        elif (self.cur[0] in ("name", "string", "integer", "float")
              or (self.cur[0] == "op" and self.cur[1] in ("(", "[", "{"))) \
                and self.cur not in (("name", "else"), ("name", "or"),
                                     ("name", "and")):
            if self.at("name", "is"):
                raise TemplateSyntaxError(
                    "You cannot chain multiple tests with is")
            args = [self.parse_postfix(self.parse_primary())]
        else:
            args = []
        node = Test(node, name, args, kwargs, dyn_args, dyn_kwargs)
        return Not(node) if negated else node


# -- compiler: tree -> closures --------------------------------------------------------


class _Scope:
    """Variables of one jinja2 frame; lookups fall through to the parents,
    then to the globals."""

    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["_Scope"] = None,
                 variables: Optional[dict] = None) -> None:
        self.parent = parent
        self.vars = {} if variables is None else variables

    def lookup(self, name: str):
        scope = self
        while scope is not None:
            value = scope.vars.get(name, _MISSING)
            if value is not _MISSING:
                return value
            scope = scope.parent
        value = GLOBALS.get(name, _MISSING)
        return Undefined(name) if value is _MISSING else value


_BINOPS = {"+": operator.add, "-": operator.sub, "*": operator.mul,
           "/": operator.truediv, "//": operator.floordiv,
           "%": operator.mod, "**": operator.pow}
_COMPARES = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
             "<=": operator.le, ">": operator.gt, ">=": operator.ge,
             "in": lambda a, b: a in b, "notin": lambda a, b: a not in b}


def _missing_callable(kind: str, name: str):
    def fail(*args, **kwargs):
        raise TemplateError(f"No {kind} named {name!r} found.")
    return fail


def _call_closure(fn, args, kwargs, dyn_args, dyn_kwargs):
    """A call's argument closures -> fn(scope) -> (positional, keyword)."""
    if dyn_args is None and dyn_kwargs is None:
        if not kwargs:
            return lambda s: ([a(s) for a in args], {})
        return lambda s: ([a(s) for a in args],
                          {k: v(s) for k, v in kwargs})

    def build(s):
        pos = [a(s) for a in args]
        kw = {k: v(s) for k, v in kwargs}
        if dyn_args is not None:
            pos.extend(dyn_args(s))
        if dyn_kwargs is not None:
            kw.update(dyn_kwargs(s))
        return pos, kw
    return build


def _concat(values) -> str:
    return "".join(map(str, values))


class _Compiler:
    """Closures of the tree: an expression becomes fn(scope) -> value, a
    statement fn(scope, out). `soft` is jinja2's soft frame (directly in an
    `if` or a conditional expression), where an unknown filter or test
    fails only when it is called."""

    # expressions -------------------------------------------------------

    def expr(self, node, soft: bool = False):
        return getattr(self, f"e_{type(node).__name__}")(node, soft)

    def _opt(self, node, soft):
        return None if node is None else self.expr(node, soft)

    def e_Const(self, node, soft):
        value = node.value
        return lambda s: value

    def e_Name(self, node, soft):
        name = node.name
        return lambda s: s.lookup(name)

    def e_TupleLit(self, node, soft):
        items = [self.expr(i, soft) for i in node.items]
        return lambda s: tuple(i(s) for i in items)

    def e_ListLit(self, node, soft):
        items = [self.expr(i, soft) for i in node.items]
        return lambda s: [i(s) for i in items]

    def e_DictLit(self, node, soft):
        pairs = [(self.expr(k, soft), self.expr(v, soft))
                 for k, v in node.pairs]
        return lambda s: {k(s): v(s) for k, v in pairs}

    def e_Getattr(self, node, soft):
        obj, attr = self.expr(node.node, soft), node.attr
        return lambda s: _getattr(obj(s), attr)

    def e_Getitem(self, node, soft):
        obj, arg = self.expr(node.node, soft), self.expr(node.arg, soft)
        return lambda s: _getitem(obj(s), arg(s))

    def e_SliceLit(self, node, soft):
        parts = [self._opt(p, soft)
                 for p in (node.start, node.stop, node.step)]
        return lambda s: slice(*(p(s) if p else None for p in parts))

    def _call_args(self, node, soft):
        return _call_closure(
            None, [self.expr(a, soft) for a in node.args],
            [(k, self.expr(v, soft)) for k, v in node.kwargs],
            self._opt(node.dyn_args, soft), self._opt(node.dyn_kwargs, soft))

    def e_Call(self, node, soft, extra: Optional[Callable] = None):
        fn = self.expr(node.node, soft)
        build = self._call_args(node, soft)

        def call(s):
            callee = fn(s)
            args, kwargs = build(s)
            if extra is not None:
                kwargs["caller"] = extra(s)
            return callee(*args, **kwargs)
        return call

    def _lookup(self, table: dict, kind: str, name: str, soft: bool):
        fn = table.get(name)
        if fn is None:
            if not soft:
                raise TemplateSyntaxError(f"No {kind} named {name!r}.")
            fn = _missing_callable(kind, name)
        return fn

    def e_Filter(self, node, soft, value: Optional[Callable] = None):
        fn = self._lookup(FILTERS, "filter", node.name, soft)
        arg = value if value is not None else self.expr(node.node, soft)
        build = self._call_args(node, soft)

        def apply(s):
            args, kwargs = build(s)
            return fn(arg(s), *args, **kwargs)
        return apply

    def e_Test(self, node, soft):
        fn = self._lookup(TESTS, "test", node.name, soft)
        arg = self.expr(node.node, soft)
        build = self._call_args(node, soft)

        def apply(s):
            args, kwargs = build(s)
            return bool(fn(arg(s), *args, **kwargs))
        return apply

    def e_CondExpr(self, node, soft):
        test = self.expr(node.test, True)
        then = self.expr(node.expr1, True)
        other = self._opt(node.expr2, True)
        if other is None:
            return lambda s: then(s) if test(s) else Undefined(
                hint="the inline if-expression evaluated to false and no "
                "else section was defined.")
        return lambda s: then(s) if test(s) else other(s)

    def e_BinOp(self, node, soft):
        fn = _BINOPS[node.op]
        left, right = self.expr(node.left, soft), self.expr(node.right, soft)
        return lambda s: fn(left(s), right(s))

    def e_Concat(self, node, soft):
        parts = [self.expr(n, soft) for n in node.nodes]
        return lambda s: _concat(p(s) for p in parts)

    def e_Compare(self, node, soft):
        first = self.expr(node.expr, soft)
        ops = [(_COMPARES[op], self.expr(n, soft)) for op, n in node.ops]

        def compare(s):
            value = first(s)
            for fn, operand in ops:
                other = operand(s)
                if not fn(value, other):
                    return False
                value = other
            return True
        return compare

    def e_And(self, node, soft):
        left, right = self.expr(node.left, soft), self.expr(node.right, soft)
        return lambda s: left(s) and right(s)

    def e_Or(self, node, soft):
        left, right = self.expr(node.left, soft), self.expr(node.right, soft)
        return lambda s: left(s) or right(s)

    def e_Not(self, node, soft):
        inner = self.expr(node.node, soft)
        return lambda s: not inner(s)

    def e_Neg(self, node, soft):
        inner = self.expr(node.node, soft)
        return lambda s: -inner(s)

    def e_Pos(self, node, soft):
        inner = self.expr(node.node, soft)
        return lambda s: +inner(s)

    # statements --------------------------------------------------------

    def body(self, nodes: list, soft: bool = False) -> list:
        return [self.stmt(n, soft) for n in nodes]

    def stmt(self, node, soft: bool = False):
        return getattr(self, f"s_{type(node).__name__}")(node, soft)

    def s_Output(self, node, soft):
        parts = []
        for child in node.nodes:
            if isinstance(child, TemplateData):
                parts.append((True, child.text))
            else:
                parts.append((False, self.expr(child, soft)))

        def output(s, out):
            for is_text, part in parts:
                out.append(part if is_text else str(part(s)))
        return output

    def s_If(self, node, soft):
        branches = [(self.expr(node.test, True), self.body(node.body, True))]
        branches += [(self.expr(t, True), self.body(b, True))
                     for t, b in node.elifs]
        if node.else_:
            branches.append((None, self.body(node.else_, True)))

        def run(s, out):
            for test, body in branches:
                if test is None or test(s):
                    for stmt in body:
                        stmt(s, out)
                    return
        return run

    def _binder(self, target):
        """target tree -> bind(scope, value)."""
        if isinstance(target, Name):
            name = target.name

            def bind(s, value):
                s.vars[name] = value
            return bind
        if isinstance(target, NSRef):
            name, attr = target.name, target.attr

            def bind_ns(s, value):
                ns = s.lookup(name)
                if not isinstance(ns, Namespace):
                    raise TemplateError("cannot assign attribute on "
                                        "non-namespace object")
                ns[attr] = value
            return bind_ns
        binders = [self._binder(t) for t in target.items]

        def bind_tuple(s, value):
            values = list(value)
            if len(values) != len(binders):
                raise TemplateError(
                    f"cannot unpack {len(values)} values into "
                    f"{len(binders)} names")
            for b, v in zip(binders, values):
                b(s, v)
        return bind_tuple

    def s_For(self, node, soft):
        bind = self._binder(node.target)
        iterable = self.expr(node.iter, soft)
        test = self._opt(node.test, False)
        body = self.body(node.body)
        else_ = self.body(node.else_)
        recursive = node.recursive

        def run_loop(s, out, items, depth0):
            items = list(items)
            if test is not None:
                kept = []
                for item in items:
                    tmp = _Scope(s)
                    bind(tmp, item)
                    if test(tmp):
                        kept.append(item)
                items = kept
            loop = LoopContext(
                items, depth0,
                (lambda it, d: render(s, it, d)) if recursive else None)
            for i, item in enumerate(items):
                child = _Scope(s)
                bind(child, item)
                loop._at(i)
                child.vars["loop"] = loop
                for stmt in body:
                    stmt(child, out)
            if not items and else_:
                child = _Scope(s)
                for stmt in else_:
                    stmt(child, out)

        def render(s, items, depth0):
            out: list = []
            run_loop(s, out, items, depth0)
            return "".join(out)

        return lambda s, out: run_loop(s, out, iterable(s), 0)

    def _macro(self, name: str, node, body_nodes: list):
        params = tuple(a.name for a in node.args)
        defaults = [self.expr(d) for d in node.defaults]
        body = self.body(body_nodes)
        flags = _undeclared(body_nodes, ("caller", "kwargs", "varargs"))
        if "caller" in params:
            flags.discard("caller")

        def make(s):
            return Macro(name, params, defaults, body, s,
                         "kwargs" in flags, "varargs" in flags,
                         "caller" in flags)
        return make

    def s_MacroDef(self, node, soft):
        make, name = self._macro(node.name, node, node.body), node.name

        def define(s, out):
            s.vars[name] = make(s)
        return define

    def s_CallBlock(self, node, soft):
        make = self._macro("caller", node, node.body)
        call = self.e_Call(node.call, soft, extra=make)
        return lambda s, out: out.append(str(call(s)))

    def _render_body(self, nodes: list):
        body = self.body(nodes)

        def render(s):
            child = _Scope(s)
            out: list = []
            for stmt in body:
                stmt(child, out)
            return "".join(out)
        return render

    def _filter_chain(self, flt, value: Callable):
        """Filter nodes whose innermost `node` is None, applied to
        `value`."""
        if flt is None:
            return value
        inner = self._filter_chain(flt.node, value)
        return self.e_Filter(flt, False, value=inner)

    def s_FilterBlock(self, node, soft):
        apply = self._filter_chain(node.filter, self._render_body(node.body))
        return lambda s, out: out.append(str(apply(s)))

    def s_With(self, node, soft):
        binders = [self._binder(t) for t in node.targets]
        values = [self.expr(v, soft) for v in node.values]
        body = self.body(node.body)

        def run(s, out):
            evaluated = [v(s) for v in values]
            child = _Scope(s)
            for b, v in zip(binders, evaluated):
                b(child, v)
            for stmt in body:
                stmt(child, out)
        return run

    def s_Assign(self, node, soft):
        bind, value = self._binder(node.target), self.expr(node.node, soft)
        return lambda s, out: bind(s, value(s))

    def s_AssignBlock(self, node, soft):
        bind = self._binder(node.target)
        value = self._filter_chain(node.filter, self._render_body(node.body))
        return lambda s, out: bind(s, value(s))


class ChatTemplate:
    """A template parsed once; `render(**variables)` as jinja2 renders it."""

    def __init__(self, source: str) -> None:
        self.source = source
        try:
            tree = _Parser(_lex(source)).subparse()
            self._nodes = _Compiler().body(tree)
        except TemplateSyntaxError:
            raise
        except (ValueError, IndexError, TypeError, RecursionError) as exc:
            raise TemplateSyntaxError(str(exc)) from None

    def render(self, **variables) -> str:
        scope = _Scope(_Scope(None, dict(variables)))
        out: list[str] = []
        try:
            for node in self._nodes:
                node(scope, out)
        except TemplateError:
            raise
        except Exception as exc:  # noqa: BLE001 — any failure is the template's
            raise TemplateError(f"{type(exc).__name__}: {exc}") from exc
        return "".join(out)
