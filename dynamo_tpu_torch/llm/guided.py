"""Guided decoding: constrained generation for structured outputs.

Copy of `dynamo_tpu/llm/guided.py` (numpy and the standard library only;
no `regex`, `jsonschema` or `outlines`): the same DFA tables, masks and
grammars, pinned equal by tests/test_torch_guided.py.

The reference protocol carries per-request guided-decoding options —
`guided_decoding: {json | regex | choice | grammar}` in
`lib/llm/src/protocols/common.rs:339-361` and OpenAI `response_format`
json_object/json_schema — and delegates enforcement to its engines
(vLLM/TRT-LLM ship xgrammar/outlines-class backends). We own the
engine, so the constraint engine lives here:

  pattern --parse--> NFA (Thompson, byte alphabet) --subset--> DFA
  (eager, over byte-class partitions) --> TokenGuide (per-DFA-state
  allowed-token masks, computed lazily per state by walking every
  vocab token's UTF-8 bytes through the DFA in a few vectorized numpy
  steps) --> GuidedProcessor (a BaseLogitsProcessor: advance on each
  generated token, mask the next-token logits; EOS becomes legal
  exactly at accepting states).

Regex subset (enough for JSON-schema output grammars): literals,
escapes (\\d \\w \\s + their negations, control escapes), `.`
(any byte except newline), classes `[...]` with ranges and negation
(ASCII), groups `(...)`/`(?:...)`, alternation, and the quantifiers
`* + ? {m} {m,} {m,n}`. Patterns are anchored (fullmatch semantics),
matching the reference's guided-regex contract.

JSON support: `schema_to_regex` compiles a practical JSON-schema subset
(object properties in declaration order, string/enum/integer/number/
boolean/null, const, nested objects, arrays with minItems/maxItems) to
a near-compact grammar (single optional space after `:` and `,`);
`json_value_regex` is the generic JSON grammar expanded to a bounded
nesting depth (regular languages cannot count brackets — the classic
outlines-style approximation).
"""

from __future__ import annotations

import json
from typing import Any, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# regex parsing -> AST


class _Pat:
    """AST nodes: ('char', byteset) | ('cat', [..]) | ('alt', [..]) |
    ('rep', node, min, max|None)."""


def _class_bytes(chars: str) -> np.ndarray:
    s = np.zeros(256, bool)
    for c in chars:
        s[ord(c)] = True
    return s


_DIGIT = _class_bytes("0123456789")
_WORD = _class_bytes(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = _class_bytes(" \t\n\r\f\v")
_ANY = np.ones(256, bool)
_ANY[ord("\n")] = False
_ESCAPE_SETS = {"d": _DIGIT, "D": ~_DIGIT, "w": _WORD, "W": ~_WORD,
                "s": _SPACE, "S": ~_SPACE}
_CTRL = {"n": "\n", "r": "\r", "t": "\t", "f": "\f", "v": "\v", "0": "\0"}


class RegexError(ValueError):
    pass


class _Parser:
    def __init__(self, pattern: str) -> None:
        self.p = pattern
        self.i = 0

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r} at "
                             f"{self.i} in {self.p!r}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self._next()
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        items = []
        while True:
            c = self._peek()
            if c is None or c in "|)":
                break
            items.append(self._quant())
        if not items:
            return ("cat", [])
        return items[0] if len(items) == 1 else ("cat", items)

    def _quant(self):
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self._next()
                node = ("rep", node, 0, None)
            elif c == "+":
                self._next()
                node = ("rep", node, 1, None)
            elif c == "?":
                self._next()
                node = ("rep", node, 0, 1)
            elif c == "{":
                save = self.i
                self._next()
                spec = ""
                while self._peek() is not None and self._peek() != "}":
                    spec += self._next()
                if self._peek() != "}" or not _valid_brace(spec):
                    self.i = save  # literal '{'
                    break
                self._next()
                lo, hi = _parse_brace(spec)
                node = ("rep", node, lo, hi)
            else:
                break
        return node

    def _atom(self):
        c = self._next()
        if c == "(":
            if self.p[self.i:self.i + 2] == "?:":
                self.i += 2
            node = self._alt()
            if self._peek() != ")":
                raise RegexError("unbalanced '('")
            self._next()
            return node
        if c == "[":
            return ("char", self._cls())
        if c == ".":
            return ("char", _ANY.copy())
        if c == "\\":
            return self._escape()
        if c in "*+?":
            raise RegexError(f"dangling quantifier {c!r}")
        return _literal(c)

    def _hex_escape(self) -> str:
        if self.i + 1 >= len(self.p):
            raise RegexError("truncated \\x escape")
        hexs = self.p[self.i:self.i + 2]
        try:
            val = int(hexs, 16)
        except ValueError:
            raise RegexError(f"bad \\x escape {hexs!r}") from None
        self.i += 2
        return chr(val)

    def _escape(self):
        if self._peek() is None:
            raise RegexError("trailing backslash")
        c = self._next()
        if c in _ESCAPE_SETS:
            return ("char", _ESCAPE_SETS[c].copy())
        if c == "x":
            return _literal(self._hex_escape())
        if c in _CTRL:
            return _literal(_CTRL[c])
        return _literal(c)  # \" \\ \. \{ etc: the literal char

    def _cls(self):
        neg = False
        if self._peek() == "^":
            self._next()
            neg = True
        s = np.zeros(256, bool)
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise RegexError("unbalanced '['")
            if c == "]" and not first:
                self._next()
                break
            first = False
            c = self._next()
            if c == "\\":
                e = self._next()
                if e in _ESCAPE_SETS:
                    s |= _ESCAPE_SETS[e]
                    continue
                c = self._hex_escape() if e == "x" else _CTRL.get(e, e)
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self._next()
                hi = self._next()
                if hi == "\\":
                    e = self._next()
                    hi = self._hex_escape() if e == "x" \
                        else _CTRL.get(e, None)
                    if hi is None:
                        raise RegexError("bad range end escape")
                lo_b, hi_b = _char_byte(c), _char_byte(hi)
                if hi_b < lo_b:
                    raise RegexError(f"bad range {c}-{hi}")
                s[lo_b:hi_b + 1] = True
            else:
                b = c.encode("utf-8")
                if len(b) != 1:
                    raise RegexError(
                        "non-ASCII characters in classes are not "
                        "supported (use them as literals)")
                s[b[0]] = True
        return ~s if neg else s


def _char_byte(c: str) -> int:
    b = c.encode("utf-8")
    if len(b) != 1:
        raise RegexError("non-ASCII range bound")
    return b[0]


def _literal(c: str):
    bs = c.encode("utf-8")
    if len(bs) == 1:
        one = np.zeros(256, bool)
        one[bs[0]] = True
        return ("char", one)
    items = []
    for b in bs:  # multi-byte char: byte sequence
        one = np.zeros(256, bool)
        one[b] = True
        items.append(("char", one))
    return ("cat", items)


def _valid_brace(spec: str) -> bool:
    parts = spec.split(",")
    if len(parts) > 2 or not parts[0].isdigit():
        return False
    return len(parts) == 1 or parts[1] == "" or parts[1].isdigit()


def _parse_brace(spec: str):
    parts = spec.split(",")
    lo = int(parts[0])
    if len(parts) == 1:
        return lo, lo
    return lo, (int(parts[1]) if parts[1] else None)


# ---------------------------------------------------------------------------
# NFA (Thompson) -> DFA (subset construction over byte-class partitions)

_MAX_DFA_STATES = 20_000
_MAX_REP = 256  # {m,n} expansion cap — guards pathological patterns


def _build_nfa(node):
    """Returns (n_states, eps: list[set], trans: list[(byteset, dst)],
    start, accept). States are ints; trans[i] applies from state i."""
    eps: list[set] = []
    trans: list[list] = []

    def new_state() -> int:
        eps.append(set())
        trans.append([])
        return len(eps) - 1

    def build(n) -> tuple:
        kind = n[0]
        if kind == "char":
            s, e = new_state(), new_state()
            trans[s].append((n[1], e))
            return s, e
        if kind == "cat":
            if not n[1]:
                s = new_state()
                return s, s
            s, e = build(n[1][0])
            for item in n[1][1:]:
                s2, e2 = build(item)
                eps[e].add(s2)
                e = e2
            return s, e
        if kind == "alt":
            s, e = new_state(), new_state()
            for br in n[1]:
                bs, be = build(br)
                eps[s].add(bs)
                eps[be].add(e)
            return s, e
        if kind == "rep":
            _, inner, lo, hi = n
            if hi is not None and (hi > _MAX_REP or lo > _MAX_REP):
                raise RegexError(f"repetition bound > {_MAX_REP}")
            if lo > _MAX_REP:
                raise RegexError(f"repetition bound > {_MAX_REP}")
            s = new_state()
            e = s
            for _ in range(lo):
                s2, e2 = build(inner)
                eps[e].add(s2)
                e = e2
            if hi is None:
                s2, e2 = build(inner)
                eps[e].add(s2)
                eps[e2].add(s2)
                end = new_state()
                eps[e].add(end)
                eps[e2].add(end)
                return s, end
            ends = [e]
            for _ in range(hi - lo):
                s2, e2 = build(inner)
                eps[e].add(s2)
                e = e2
                ends.append(e)
            end = new_state()
            for x in ends:
                eps[x].add(end)
            return s, end
        raise RegexError(f"unknown node {kind}")

    start, accept = build(node)
    return eps, trans, start, accept


def compile_regex(pattern: str):
    """pattern -> Dfa (fullmatch semantics over UTF-8 bytes)."""
    node = _Parser(pattern).parse()
    eps, trans, start, accept = _build_nfa(node)

    n = len(eps)
    closure_cache: dict[int, frozenset] = {}

    def closure(states: frozenset) -> frozenset:
        out = set()
        stack = list(states)
        while stack:
            s = stack.pop()
            if s in out:
                continue
            out.add(s)
            stack.extend(eps[s] - out)
        return frozenset(out)

    # Byte partitions: group bytes by the signature of NFA transitions
    # that accept them — subset construction then runs over ~dozens of
    # classes instead of 256 bytes.
    all_sets = [bs for tlist in trans for (bs, _) in tlist]
    if all_sets:
        sig = np.zeros((256,), np.int64)
        mult = 1
        for bs in all_sets:
            sig = sig * 2 + bs.astype(np.int64)
            mult += 1
            if mult % 50 == 0:  # avoid int64 overflow: re-hash
                _, sig = np.unique(sig, return_inverse=True)
        _, class_of = np.unique(sig, return_inverse=True)
    else:
        class_of = np.zeros(256, np.int64)
    n_classes = int(class_of.max()) + 1
    class_rep = np.zeros(n_classes, np.int64)
    for cls in range(n_classes):
        class_rep[cls] = int(np.argmax(class_of == cls))

    start_set = closure(frozenset([start]))
    dfa_ids: dict[frozenset, int] = {start_set: 0}
    dfa_list = [start_set]
    table_cls: list[np.ndarray] = []
    i = 0
    while i < len(dfa_list):
        cur = dfa_list[i]
        row = np.full(n_classes, -1, np.int32)
        for cls in range(n_classes):
            byte = int(class_rep[cls])
            nxt = set()
            for s in cur:
                for bs, dst in trans[s]:
                    if bs[byte]:
                        nxt.add(dst)
            if nxt:
                closed = closure(frozenset(nxt))
                if closed not in dfa_ids:
                    if len(dfa_ids) >= _MAX_DFA_STATES:
                        raise RegexError(
                            "pattern compiles to too many DFA states")
                    dfa_ids[closed] = len(dfa_list)
                    dfa_list.append(closed)
                row[cls] = dfa_ids[closed]
        table_cls.append(row)
        i += 1

    table = np.stack(table_cls)[:, class_of]  # [n_dfa, 256]
    accepting = np.array([accept in s for s in dfa_list], bool)
    return Dfa(table, accepting)


class Dfa:
    """Dense byte DFA: table [n_states, 256] int32 (-1 = dead),
    accepting [n_states] bool. State 0 is the start."""

    def __init__(self, table: np.ndarray, accepting: np.ndarray) -> None:
        self.table = table
        self.accepting = accepting

    def fullmatch(self, data: bytes) -> bool:
        s = 0
        for b in data:
            s = int(self.table[s, b])
            if s < 0:
                return False
        return bool(self.accepting[s])


# ---------------------------------------------------------------------------
# token-level guide

class TokenGuide:
    """Per-DFA-state allowed-token masks over a tokenizer's vocab.

    Token byte walks are vectorized: all tokens advance one byte column
    at a time through the DFA table, so computing a new state's mask is
    O(max_token_len) numpy steps over [V]."""

    def __init__(self, dfa: Dfa, token_bytes: list[Optional[bytes]],
                 eos_ids: Sequence[int]) -> None:
        self.dfa = dfa
        self.eos_ids = [int(e) for e in eos_ids]
        v = len(token_bytes)
        lens = np.array([len(t) if t else 0 for t in token_bytes],
                        np.int32)
        lmax = max(1, int(lens.max()))
        padded = np.zeros((v, lmax), np.uint8)
        for i, t in enumerate(token_bytes):
            if t:
                padded[i, :len(t)] = np.frombuffer(t, np.uint8)
        self._padded = padded
        self._lens = lens
        # empty/special tokens can never advance a constraint
        self._eligible = lens > 0
        self._end_cache: dict[int, np.ndarray] = {}
        self._mask_cache: dict[int, np.ndarray] = {}

    def _end_states(self, state: int) -> np.ndarray:
        """[V] int32: DFA state after consuming each token from
        `state` (-1 = dead)."""
        out = self._end_cache.get(state)
        if out is None:
            v, lmax = self._padded.shape
            cur = np.full(v, state, np.int32)
            for col in range(lmax):
                active = (self._lens > col) & (cur >= 0)
                if not active.any():
                    break
                cur[active] = self.dfa.table[cur[active],
                                             self._padded[active, col]]
            cur[~self._eligible] = -1
            out = cur
            self._end_cache[state] = out
        return out

    def allowed(self, state: int) -> np.ndarray:
        """[V] bool: tokens that keep the constraint alive from
        `state` (EOS excluded — see `eos_allowed`)."""
        mask = self._mask_cache.get(state)
        if mask is None:
            mask = self._end_states(state) >= 0
            self._mask_cache[state] = mask
        return mask

    def eos_allowed(self, state: int) -> bool:
        return bool(self.dfa.accepting[state])

    def advance(self, state: int, token_id: int) -> int:
        if token_id in self.eos_ids:
            return state
        ends = self._end_states(state)
        if token_id >= len(ends):
            return -1
        return int(ends[token_id])


_TOKEN_BYTES_CACHE: dict[int, list] = {}


def _gpt2_byte_decoder() -> dict[str, int]:
    """Inverse of HF byte-level BPE's bytes_to_unicode: vocab char ->
    original byte. Byte-level vocabs spell every token with these 256
    characters (printable ASCII and Latin-1 map to themselves; the
    rest shift up past U+0100), so a token string whose chars ALL land
    in this table losslessly inverts to its true bytes."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_BYTE_DECODER = _gpt2_byte_decoder()


def token_bytes_for(tokenizer) -> list[Optional[bytes]]:
    """Vocab id -> produced UTF-8 bytes (None for specials/unused).

    Byte-level-BPE vocabs (gpt2/llama3-style) are inverted through the
    raw token string and the bytes_to_unicode table — decode() yields
    U+FFFD for tokens carrying partial UTF-8 sequences (a multi-byte
    char split across tokens), which used to ban those tokens and make
    non-ASCII content ungeneratable under guided decoding. Cached per
    tokenizer: a 150k-vocab scan is seconds of decode calls and is
    identical for every pattern."""
    cached = _TOKEN_BYTES_CACHE.get(id(tokenizer))
    if cached is not None:
        return cached[1]
    out: list[Optional[bytes]] = []
    specials = getattr(tokenizer, "SPECIALS", {})
    token_text = getattr(tokenizer, "token_text", lambda i: None)
    raws = [token_text(i) for i in range(tokenizer.vocab_size)]
    # Vocab-level gate: byte-level-BPE vocabs (gpt2/llama3/qwen) spell
    # the space/newline bytes as Ġ (U+0120) / Ċ (U+010A) — present in
    # thousands of their tokens and in no other tokenizer family —
    # while SentencePiece vocabs carry the ▁ (U+2581) word marker
    # instead. Requiring Ġ/Ċ and rejecting on ▁ keeps non-byte-level
    # vocabs (SentencePiece '<0x0A>' byte fallback, WordPiece '##ing',
    # multilingual text tokens like 'ā' that happen to land in the
    # shifted alphabet) on the decode() path exactly as before.
    byte_level = any(
        raw and ("Ġ" in raw or "Ċ" in raw) for raw in raws
    ) and not any(raw and "▁" in raw for raw in raws)
    for i in range(tokenizer.vocab_size):
        if i in specials or i in getattr(tokenizer, "eos_token_ids", []):
            out.append(None)
            continue
        try:
            text = tokenizer.decode([i])
        except Exception:  # noqa: BLE001 — unused vocab slots
            out.append(None)
            continue
        raw = raws[i]
        # Empty decode = a special/added-control token the detokenizer
        # skips ('<|im_start|>' etc.) — it must stay banned even though
        # its raw spelling is plain ASCII; inverting it would let guided
        # patterns admitting '<' emit chat-control tokens the client
        # never sees.
        if byte_level and raw and text \
                and all(c in _BYTE_DECODER for c in raw):
            # byte-level BPE spelling: recover the true bytes, partial
            # UTF-8 sequences included (ASCII round-trips identically)
            out.append(bytes(_BYTE_DECODER[c] for c in raw))
            continue
        if not text or "�" in text:
            # partial UTF-8 pieces outside a byte-level vocab; byte
            # tokenizers expose raw bytes below 256 instead
            if hasattr(tokenizer, "SPECIALS") and i < 256:
                out.append(bytes([i]))
            else:
                out.append(None)
            continue
        out.append(text.encode("utf-8"))
    if len(_TOKEN_BYTES_CACHE) > 8:
        _TOKEN_BYTES_CACHE.clear()
    _TOKEN_BYTES_CACHE[id(tokenizer)] = (tokenizer, out)
    return out


# ---------------------------------------------------------------------------
# JSON grammars

_WS = " ?"  # near-compact: one optional space after ':' and ','
_STRING = r'"([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"'
_INTEGER = r"-?(0|[1-9][0-9]*)"
_NUMBER = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?"
_BOOLEAN = r"(true|false)"
_NULL = r"null"


def _re_escape(text: str) -> str:
    out = []
    for c in text:
        if c in r"\.[]{}()*+?|^$/-":
            out.append("\\" + c)
        elif c == "\n":
            out.append(r"\n")
        elif c == "\t":
            out.append(r"\t")
        else:
            out.append(c)
    return "".join(out)


def _json_literal_regex(value: Any) -> str:
    return _re_escape(json.dumps(value, ensure_ascii=True))


def schema_to_regex(schema: dict, depth: int = 0) -> str:
    """JSON-schema subset -> output regex (see module docstring)."""
    if depth > 8:
        raise RegexError("schema nesting too deep (max 8)")
    if not isinstance(schema, dict):
        raise RegexError("schema must be an object")
    if "$ref" in schema or "$defs" in schema:
        raise RegexError("$ref/$defs are not supported")
    if "const" in schema:
        return _json_literal_regex(schema["const"])
    if "enum" in schema:
        opts = "|".join(_json_literal_regex(v) for v in schema["enum"])
        return f"({opts})"
    if "anyOf" in schema or "oneOf" in schema:
        subs = schema.get("anyOf") or schema.get("oneOf")
        return "(" + "|".join(schema_to_regex(s, depth + 1)
                              for s in subs) + ")"
    if not schema:
        # {} permits ANY JSON value (bounded nesting depth)
        return json_value_regex()
    typ = schema.get("type")
    if isinstance(typ, list):
        return "(" + "|".join(
            schema_to_regex({**schema, "type": t}, depth + 1)
            for t in typ) + ")"
    if typ == "string":
        return _STRING
    if typ == "integer":
        return _INTEGER
    if typ == "number":
        return _NUMBER
    if typ == "boolean":
        return _BOOLEAN
    if typ == "null":
        return _NULL
    if typ == "array":
        item = schema_to_regex(schema.get("items", {"type": "string"}),
                               depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        more = f"(,{_WS}{item})"
        if hi is not None and int(hi) == 0:
            if lo > 0:
                raise RegexError("bad minItems/maxItems")
            return r"\[\]"  # maxItems 0: the array must be empty
        if hi is None:
            tail = f"{more}{{{max(lo - 1, 0)},}}" if lo > 1 else f"{more}*"
        else:
            hi = int(hi)
            if lo and hi < lo:
                raise RegexError("bad minItems/maxItems")
            tail = f"{more}{{{max(lo - 1, 0)},{hi - 1}}}"
        body = f"{item}{tail}"
        if lo == 0:
            body = f"({body})?"
        return rf"\[{body}\]"
    if typ == "object" or "properties" in schema:
        props = schema.get("properties") or {}
        if not props:
            # open object: any JSON object (bounded-depth values)
            return json_object_regex()
        parts = []
        for name, sub in props.items():
            key = _json_literal_regex(name)
            parts.append(f"{key}:{_WS}{schema_to_regex(sub, depth + 1)}")
        body = f",{_WS}".join(parts)
        return r"\{" + body + r"\}"
    raise RegexError(f"unsupported schema: {json.dumps(schema)[:120]}")


def json_value_regex(max_depth: int = 4) -> str:
    """Generic JSON value, bracket nesting bounded at `max_depth` (a
    regular approximation of the context-free JSON grammar)."""
    scalar = f"({_STRING}|{_NUMBER}|{_BOOLEAN}|{_NULL})"
    value = scalar
    for _ in range(max_depth):
        arr = rf"\[({value}(,{_WS}{value})*)?\]"
        obj = (rf"\{{({_STRING}:{_WS}{value}"
               rf"(,{_WS}{_STRING}:{_WS}{value})*)?\}}")
        value = f"({scalar}|{arr}|{obj})"
    return value


def json_object_regex(max_depth: int = 4) -> str:
    """response_format json_object: the top level must be an object."""
    value = json_value_regex(max_depth - 1)
    return (rf"\{{({_STRING}:{_WS}{value}"
            rf"(,{_WS}{_STRING}:{_WS}{value})*)?\}}")


def tool_call_regex(format_name: str, tools: list,
                    specific: Optional[str] = None) -> str:
    """Output grammar for a FORCED tool call (OpenAI tool_choice
    'required' / named function): the call JSON is constrained to a
    declared function name + its parameter schema, wrapped in the
    model's tool-parser format so the parser extracts it losslessly.
    """
    fmt = (format_name or "").lower()
    args_key = "parameters" if fmt == "llama3_json" else "arguments"
    calls = []
    for tool in tools or []:
        fn = tool.get("function", tool) if isinstance(tool, dict) else {}
        name = fn.get("name")
        if not isinstance(name, str) or not name:
            continue
        if specific is not None and name != specific:
            continue
        params = fn.get("parameters")
        args_re = schema_to_regex(params) if params else \
            json_object_regex()
        calls.append(
            rf'\{{"name":{_WS}"{_re_escape(name)}",{_WS}'
            rf'"{args_key}":{_WS}{args_re}\}}')
    if not calls:
        raise RegexError(
            f"tool_choice names no declared function "
            f"({specific!r} not in tools)" if specific is not None
            else "tool_choice 'required' needs non-empty tools")
    call = "(" + "|".join(calls) + ")"
    if fmt in ("hermes", "qwen"):
        return rf"<tool_call>\n?{call}\n?</tool_call>"
    if fmt == "llama3_json":
        return call  # the whole message IS the call object
    if fmt == "mistral":
        return rf"\[TOOL_CALLS\] ?\[{call}\]"
    raise RegexError(
        f"tool_choice forcing is not supported for tool parser "
        f"{format_name!r} (hermes/qwen, llama3_json, mistral)")


# ---------------------------------------------------------------------------
# the logits processor

class GuidedProcessor:
    """BaseLogitsProcessor enforcing a DFA constraint. Masks the next-
    token logits to transitions that keep the DFA alive; EOS rows stay
    legal only at accepting states. On a dead state (shouldn't happen
    under its own masking) it forces EOS rather than emit garbage."""

    def __init__(self, guide: TokenGuide) -> None:
        self.guide = guide
        self.state = 0
        self._consumed = 0

    def __call__(self, input_ids: Sequence[int],
                 logits: np.ndarray) -> None:
        for tok in list(input_ids)[self._consumed:]:
            if self.state >= 0:
                self.state = self.guide.advance(self.state, int(tok))
            self._consumed += 1
        eos = [e for e in self.guide.eos_ids if e < logits.shape[-1]]
        if self.state < 0:
            logits[:] = -np.inf
            for e in eos:
                logits[e] = 0.0
            return
        mask = self.guide.allowed(self.state)[:logits.shape[-1]]
        keep = np.zeros(logits.shape[-1], bool)
        keep[:mask.shape[0]] = mask
        if self.guide.eos_allowed(self.state):
            for e in eos:
                keep[e] = True
        if not keep.any():
            for e in eos:
                keep[e] = True
        logits[~keep] = -np.inf


_GUIDE_CACHE: dict = {}


def make_guided_processor(tokenizer=None, *, regex: Optional[str] = None,
                          choice: Optional[list] = None,
                          json_schema: Optional[dict] = None,
                          json_object: bool = False,
                          tool_call: Optional[dict] = None,
                          ) -> GuidedProcessor:
    """Factory registered as the 'guided' logits processor. Exactly one
    of regex / choice / json_schema / json_object / tool_call selects
    the grammar. Compiled TokenGuides are cached per (tokenizer,
    pattern) — schema compilation and vocab mask precomputation amortize
    across requests.
    """
    given = [regex is not None, choice is not None,
             json_schema is not None, bool(json_object),
             tool_call is not None]
    if sum(given) != 1:
        raise ValueError(
            "guided decoding needs exactly one of regex / choice / "
            "json_schema / json_object / tool_call")
    if tokenizer is None:
        raise ValueError("guided decoding needs the worker tokenizer")
    if regex is not None:
        pattern = regex
    elif choice is not None:
        if not choice or not all(isinstance(c, str) for c in choice):
            raise ValueError("choice must be a non-empty string list")
        pattern = "(" + "|".join(_re_escape(c) for c in choice) + ")"
    elif json_schema is not None:
        pattern = schema_to_regex(json_schema)
    elif tool_call is not None:
        pattern = tool_call_regex(tool_call.get("format", ""),
                                  tool_call.get("tools") or [],
                                  tool_call.get("name"))
    else:
        pattern = json_object_regex()
    key = (id(tokenizer), pattern)
    entry = _GUIDE_CACHE.get(key)
    if entry is None:
        dfa = compile_regex(pattern)
        guide = TokenGuide(dfa, token_bytes_for(tokenizer),
                           getattr(tokenizer, "eos_token_ids", []))
        if len(_GUIDE_CACHE) > 64:
            _GUIDE_CACHE.clear()
        # hold the tokenizer so its id cannot be recycled underneath
        # the cache key while this entry lives
        _GUIDE_CACHE[key] = (tokenizer, guide)
    else:
        guide = entry[1]
    return GuidedProcessor(guide)
