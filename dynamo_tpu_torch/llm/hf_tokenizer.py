"""HF `tokenizer.json` tokenizers, interpreted on the standard library.

Port of `HfTokenizer` in `dynamo_tpu/llm/tokenizer.py`, which wraps the
`tokenizers` package; the card's machine has neither it nor `regex`, so this
module reads the file and runs the same pipeline itself:

  added tokens -> normalizer -> pre-tokenizer -> model (BPE / WordLevel)

for `encode` (the reference calls it with add_special_tokens=False, so the
post-processor adds nothing), and id -> token string -> decoder for
`decode` (special tokens skipped, ids outside the vocabulary dropped, as
the `tokenizers` package does).

Implemented components (anything else in a tokenizer.json raises
`UnsupportedTokenizer`, naming the file and the component):

  models          BPE (merges as "a b" strings or [a, b] pairs,
                  byte_fallback, ignore_merges, unk_token, fuse_unk,
                  continuing_subword_prefix, end_of_word_suffix), WordLevel
  normalizers     NFC, NFKC, Lowercase, Prepend, Replace, Sequence
  pre-tokenizers  ByteLevel (add_prefix_space, use_regex), Split (Regex or
                  String pattern, every behavior, invert), Metaspace
                  (replacement, prepend_scheme, split), Digits,
                  WhitespaceSplit, Sequence
  decoders        ByteLevel, Metaspace, ByteFallback, Fuse, Strip, Replace,
                  Sequence
  post-processors TemplateProcessing, ByteLevel, BertProcessing,
                  RobertaProcessing, Sequence (none adds anything when
                  special tokens are not requested)

The pre-tokenizer regexes are Oniguruma patterns. Python's `re` has no
`\\p{..}` classes and its `\\s` also matches U+001C-U+001F, which are not
Unicode White_Space; `translate_regex` rewrites `\\p{X}` / `\\P{X}` (general
categories) and `\\s` / `\\S` into explicit character classes built once
from `unicodedata`. BPE results are cached per pre-token: this runs on the
frontend's request path.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Callable, Optional, Sequence

from .tokenizer import Tokenizer


class UnsupportedTokenizer(ValueError):
    """A tokenizer.json this port cannot interpret exactly."""


# -- Unicode classes -------------------------------------------------------------

# Unicode White_Space (what Rust's char::is_whitespace and Oniguruma's \s
# match)
WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))


def _is_space(c: str) -> bool:
    return c in WHITE_SPACE


def _is_numeric(c: str) -> bool:
    """Rust's char::is_numeric: general category Nd, Nl or No."""
    return unicodedata.category(c)[0] == "N"


@lru_cache(maxsize=None)
def _all_category_ranges() -> dict:
    """General category (two letters) -> code point ranges [(lo, hi)], in
    one pass over the code space."""
    ranges: dict[str, list] = {}
    last: dict[str, int] = {}
    for cp in range(sys.maxunicode + 1):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        cat = unicodedata.category(chr(cp))
        spans = ranges.setdefault(cat, [])
        if last.get(cat) == cp - 1:
            spans[-1][1] = cp
        else:
            spans.append([cp, cp])
        last[cat] = cp
    return ranges


@lru_cache(maxsize=None)
def _category_ranges(category: str) -> tuple:
    """Code point ranges whose general category is `category` (one letter:
    every subcategory), merged and sorted."""
    spans = sorted(span for cat, cat_spans in _all_category_ranges().items()
                   if cat.startswith(category) for span in cat_spans)
    merged: list = []
    for lo, hi in spans:
        if merged and lo == merged[-1][1] + 1:
            merged[-1][1] = hi
        else:
            merged.append([lo, hi])
    return tuple((lo, hi) for lo, hi in merged)


def _class_body(ranges) -> str:
    def esc(cp: int) -> str:
        return f"\\U{cp:08x}"

    return "".join(esc(lo) if lo == hi else f"{esc(lo)}-{esc(hi)}"
                   for lo, hi in ranges)


_SPACE_BODY = _class_body(sorted((ord(c), ord(c)) for c in WHITE_SPACE))
_PROP = re.compile(r"\\([pP])\{([A-Za-z]{1,2})\}")


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern as a Python `re` pattern of the same meaning:
    `\\p{X}` / `\\P{X}` (general categories) become explicit classes, `\\s` /
    `\\S` Unicode White_Space. Raises UnsupportedTokenizer for a property
    it does not implement and for a negated class escape inside [...]."""
    out = []
    i, n, depth = 0, len(pattern), 0
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            m = _PROP.match(pattern, i)
            if m:
                neg = m.group(1) == "P"
                ranges = _category_ranges(m.group(2))
                if not ranges:
                    raise UnsupportedTokenizer(
                        f"regex property {m.group(0)!r} is not implemented")
                body = _class_body(ranges)
                if depth:
                    if neg:
                        raise UnsupportedTokenizer(
                            f"{m.group(0)!r} inside a character class")
                    out.append(body)
                else:
                    out.append(f"[{'^' if neg else ''}{body}]")
                i = m.end()
                continue
            nxt = pattern[i + 1]
            if nxt in "pP":
                raise UnsupportedTokenizer(
                    f"regex property at {pattern[i:i + 12]!r} is not "
                    "implemented")
            if nxt in "sS":
                if depth:
                    if nxt == "S":
                        raise UnsupportedTokenizer(
                            "\\S inside a character class")
                    out.append(_SPACE_BODY)
                else:
                    out.append(f"[{'^' if nxt == 'S' else ''}{_SPACE_BODY}]")
            else:
                out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not depth:
            depth = 1
            out.append(c)
            i += 1
            # a leading ^ and a leading ] belong to the class
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "[" and depth:
            raise UnsupportedTokenizer("nested character classes")
        if c == "]" and depth:
            depth = 0
        out.append(c)
        i += 1
    return "".join(out)


# -- splitting (tokenizers' NormalizedString::split) ----------------------------


def _find_matches(text: str, finder: Callable) -> list:
    """[(start, end, is_match)] covering `text`."""
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for start, end in finder(text):
        if prev != start:
            out.append((prev, start, False))
        out.append((start, end, True))
        prev = end
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def _compile(pattern: str):
    """An Oniguruma pattern compiled by `re` (see `translate_regex`)."""
    try:
        return re.compile(translate_regex(pattern))
    except re.error as exc:
        raise UnsupportedTokenizer(f"regex {pattern!r}: {exc}") from None


def _regex_finder(compiled):
    return lambda text: ((m.start(), m.end()) for m in compiled.finditer(text))


def _char_finder(pred):
    return lambda text: ((i, i + 1) for i, c in enumerate(text) if pred(c))


def _split(text: str, finder, behavior: str, invert: bool = False) -> list:
    """[(start, end)] pieces of `text` after a split with `behavior`."""
    matches = [(s, e, m != invert) for s, e, m in _find_matches(text, finder)]
    if behavior == "Isolated":
        spans = [(s, e) for s, e, _ in matches]
    elif behavior == "Removed":
        spans = [(s, e) for s, e, m in matches if not m]
    elif behavior == "Contiguous":
        spans, prev = [], False
        for s, e, m in matches:
            if m == prev and spans:
                spans[-1] = (spans[-1][0], e)
            else:
                spans.append((s, e))
            prev = m
    elif behavior == "MergedWithPrevious":
        spans, prev = [], False
        for s, e, m in matches:
            if m and not prev and spans:
                spans[-1] = (spans[-1][0], e)
            else:
                spans.append((s, e))
            prev = m
    elif behavior == "MergedWithNext":
        spans, prev = [], False
        for s, e, m in reversed(matches):
            if m and not prev and spans:
                spans[-1] = (s, spans[-1][1])
            else:
                spans.append((s, e))
            prev = m
        spans.reverse()
    else:
        raise UnsupportedTokenizer(f"split behavior {behavior!r}")
    return [(s, e) for s, e in spans if e > s]


def _pattern_finder(spec: dict):
    if not isinstance(spec, dict) or len(spec) != 1:
        raise UnsupportedTokenizer(f"pattern {spec!r}")
    kind, value = next(iter(spec.items()))
    if kind == "String":
        if not value:
            return lambda text: iter(())
        return _regex_finder(re.compile(re.escape(value)))
    if kind == "Regex":
        return _regex_finder(_compile(value))
    raise UnsupportedTokenizer(f"pattern kind {kind!r}")


# -- normalizers ----------------------------------------------------------------


def _build_normalizer(spec: Optional[dict]) -> Optional[Callable]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_build_normalizer(s) for s in spec["normalizers"]]

        def seq(text: str) -> str:
            for part in parts:
                text = part(text)
            return text
        return seq
    if kind in ("NFC", "NFKC"):
        return lambda text: unicodedata.normalize(kind, text)
    if kind == "Lowercase":
        # char by char, as Rust's char::to_lowercase (no final-sigma rule)
        return lambda text: "".join(c.lower() for c in text)
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda text: prefix + text if text else text
    if kind == "Replace":
        finder = _pattern_finder(spec["pattern"])
        content = spec["content"]

        def replace(text: str) -> str:
            out, prev = [], 0
            for s, e in finder(text):
                out.append(text[prev:s])
                out.append(content)
                prev = e
            out.append(text[prev:])
            return "".join(out)
        return replace
    raise UnsupportedTokenizer(f"normalizer {kind!r}")


# -- pre-tokenizers ---------------------------------------------------------------

# A pre-tokenizer maps pieces (text, at_start) to pieces; at_start marks
# the piece that begins the input (Metaspace's prepend_scheme "first" looks
# at it).


@lru_cache(maxsize=None)
def bytes_to_unicode() -> dict:
    """GPT-2's byte -> printable character table."""
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
    return {b: chr(c) for b, c in zip(bs, cs)}


GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _split_pieces(pieces: list, finder, behavior: str,
                  invert: bool = False) -> list:
    out = []
    for text, at_start in pieces:
        for s, e in _split(text, finder, behavior, invert):
            out.append((text[s:e], at_start and s == 0))
    return out


def _build_pre_tokenizer(spec: Optional[dict]) -> Optional[Callable]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_build_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces: list) -> list:
            for part in parts:
                pieces = part(pieces)
            return pieces
        return seq
    if kind == "ByteLevel":
        add_prefix = spec.get("add_prefix_space", True)
        finder = (_regex_finder(_compile(GPT2_PATTERN))
                  if spec.get("use_regex", True) else None)
        table = bytes_to_unicode()

        def byte_level(pieces: list) -> list:
            out = []
            for text, at_start in pieces:
                if add_prefix and not text.startswith(" "):
                    text = " " + text
                split = ([(text, at_start)] if finder is None else
                         _split_pieces([(text, at_start)], finder,
                                       "Isolated"))
                out.extend(("".join(table[b] for b in t.encode("utf-8")), a)
                           for t, a in split)
            return out
        return byte_level
    if kind == "Split":
        finder = _pattern_finder(spec["pattern"])
        behavior = spec["behavior"]
        invert = bool(spec.get("invert", False))
        _split("", finder, behavior, invert)  # refuses an unknown behavior
        return lambda pieces: _split_pieces(pieces, finder, behavior, invert)
    if kind == "Metaspace":
        repl = spec.get("replacement", "\u2581")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        if scheme not in ("always", "first", "never"):
            raise UnsupportedTokenizer(f"Metaspace prepend_scheme {scheme!r}")
        split = spec.get("split", True)
        finder = _char_finder(lambda c: c == repl)

        def metaspace(pieces: list) -> list:
            out = []
            for text, at_start in pieces:
                text = text.replace(" ", repl)
                if not text.startswith(repl) and (
                        scheme == "always"
                        or (scheme == "first" and at_start)):
                    text = repl + text
                if split:
                    out.extend(_split_pieces([(text, at_start)], finder,
                                             "MergedWithNext"))
                elif text:
                    out.append((text, at_start))
            return out
        return metaspace
    if kind == "Digits":
        behavior = ("Isolated" if spec.get("individual_digits", False)
                    else "Contiguous")
        finder = _char_finder(_is_numeric)
        return lambda pieces: _split_pieces(pieces, finder, behavior)
    if kind == "WhitespaceSplit":
        finder = _char_finder(_is_space)
        return lambda pieces: _split_pieces(pieces, finder, "Removed")
    raise UnsupportedTokenizer(f"pre-tokenizer {kind!r}")


# -- decoders -------------------------------------------------------------------

_BYTE_TOKEN = re.compile(r"<0x([0-9A-Fa-f]{2})>")


def _build_decoder(spec: Optional[dict]) -> Optional[Callable]:
    """A decoder: list of token strings -> list of strings."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_build_decoder(s) for s in spec["decoders"]]

        def seq(tokens: list) -> list:
            for part in parts:
                tokens = part(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        table = {c: b for b, c in bytes_to_unicode().items()}

        def byte_level(tokens: list) -> list:
            buf = bytearray()
            for t in tokens:
                raw = [table.get(c) for c in t]
                buf.extend(t.encode("utf-8") if None in raw else raw)
            return [buf.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Metaspace":
        repl = spec.get("replacement", "\u2581")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        drop_first = scheme != "never"

        def metaspace(tokens: list) -> list:
            return [t.replace(repl, "" if i == 0 and drop_first else " ")
                    for i, t in enumerate(tokens)]
        return metaspace
    if kind == "ByteFallback":
        def byte_fallback(tokens: list) -> list:
            out, pending = [], bytearray()

            def flush() -> None:
                if pending:
                    try:
                        out.append(pending.decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend("\ufffd" for _ in pending)
                    pending.clear()

            for t in tokens:
                m = _BYTE_TOKEN.fullmatch(t) if len(t) == 6 else None
                if m:
                    pending.append(int(m.group(1), 16))
                else:
                    flush()
                    out.append(t)
            flush()
            return out
        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens: list) -> list:
            out = []
            for t in tokens:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = len(t)
                for _ in range(min(stop, len(t))):
                    if t[b - 1] == content:
                        b -= 1
                    else:
                        break
                out.append(t[a:max(a, b)])
            return out
        return strip
    if kind == "Replace":
        finder = _pattern_finder(spec["pattern"])
        content = spec["content"]

        def replace(tokens: list) -> list:
            out = []
            for t in tokens:
                parts, prev = [], 0
                for s, e in finder(t):
                    parts += [t[prev:s], content]
                    prev = e
                parts.append(t[prev:])
                out.append("".join(parts))
            return out
        return replace
    raise UnsupportedTokenizer(f"decoder {kind!r}")


_POST_PROCESSORS = {"TemplateProcessing", "ByteLevel", "BertProcessing",
                    "RobertaProcessing"}


def _check_post_processor(spec: Optional[dict]) -> None:
    if spec is None:
        return
    kind = spec.get("type")
    if kind == "Sequence":
        for s in spec["processors"]:
            _check_post_processor(s)
    elif kind not in _POST_PROCESSORS:
        raise UnsupportedTokenizer(f"post-processor {kind!r}")


# -- models ---------------------------------------------------------------------


class _BPE:
    def __init__(self, spec: dict) -> None:
        if spec.get("dropout"):
            raise UnsupportedTokenizer("BPE dropout")
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.prefix = spec.get("continuing_subword_prefix") or None
        self.suffix = spec.get("end_of_word_suffix") or None
        # (left id, right id) -> (rank, merged id)
        self.merges: dict[tuple, tuple] = {}
        plen = len(self.prefix) if self.prefix else 0
        for rank, merge in enumerate(spec.get("merges", [])):
            if isinstance(merge, str):
                parts = merge.split(" ")
                if len(parts) != 2:
                    raise UnsupportedTokenizer(f"merge {merge!r}")
                a, b = parts
            else:
                a, b = merge
            if a not in self.vocab or b not in self.vocab:
                raise UnsupportedTokenizer(f"merge {a!r} {b!r} names a token "
                                           "outside the vocabulary")
            merged = a + (b[plen:] if plen and b.startswith(self.prefix)
                          else b)
            if merged not in self.vocab:
                raise UnsupportedTokenizer(f"merge {a!r} {b!r}: {merged!r} "
                                           "is not in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank,
                                                           self.vocab[merged])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self._cache: dict[str, list] = {}

    def tokenize(self, word: str) -> list:
        if not word:
            return []
        hit = self._cache.get(word)
        if hit is None:
            hit = self._tokenize(word)
            if len(self._cache) >= 100_000:
                self._cache.clear()
            self._cache[word] = hit
        return hit

    def _unk_id(self) -> int:
        if self.unk not in self.vocab:
            raise ValueError(f"unk token {self.unk!r} is not in the "
                             "vocabulary")
        return self.vocab[self.unk]

    def _tokenize(self, word: str) -> list:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        ids: list[int] = []
        unk = False  # a pending unk (fused runs add one)
        last = len(word) - 1
        for i, ch in enumerate(word):
            s = ch
            if i and self.prefix:
                s = self.prefix + s
            if i == last and self.suffix:
                s = s + self.suffix
            tid = self.vocab.get(s)
            if tid is not None:
                if unk:
                    ids.append(self._unk_id())
                    unk = False
                ids.append(tid)
                continue
            if self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>")
                            for b in s.encode("utf-8")]
                if all(b is not None for b in byte_ids):
                    ids.extend(byte_ids)
                    continue
            if self.unk is not None:
                if unk and not self.fuse_unk:
                    ids.append(self._unk_id())
                unk = True
        if unk:
            ids.append(self._unk_id())
        return self._merge(ids)

    def _merge(self, ids: list) -> list:
        """Apply merges lowest rank first (leftmost among equals), as the
        `tokenizers` package's priority queue does."""
        n = len(ids)
        if n < 2:
            return ids
        sym = list(ids)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prv[nxt[right]] = pos
            if prv[pos] != -1:
                m = self.merges.get((sym[prv[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] != -1:
                m = self.merges.get((new_id, sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        out, i = [], 0
        while i != -1:
            out.append(sym[i])
            i = nxt[i]
        return out


class _WordLevel:
    def __init__(self, spec: dict) -> None:
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.id_to_token = {i: t for t, i in self.vocab.items()}

    def tokenize(self, word: str) -> list:
        tid = self.vocab.get(word)
        if tid is None:
            tid = self.vocab.get(self.unk)
            if tid is None:
                raise ValueError(f"WordLevel: {word!r} is not in the "
                                 "vocabulary and there is no unk token")
        return [tid]


def _build_model(spec: dict):
    kind = spec.get("type")
    if kind == "BPE" or (kind is None and "merges" in spec):
        return _BPE(spec)
    if kind == "WordLevel":
        return _WordLevel(spec)
    raise UnsupportedTokenizer(f"model {kind!r}")


# -- added tokens -----------------------------------------------------------------


# Other_Alphabetic code points outside the marks (Unicode 15.0 PropList.txt):
# the circled and squared Latin letters, general category So. With them the
# categories below make up Unicode `\w` as regex-syntax defines it, which is
# what the tokenizers library tests single_word boundaries with.
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                       (0x1F170, 0x1F189))
_WORD_CATEGORIES = frozenset({"Nl", "Nd", "Pc"})


def _is_word_char(c: str) -> bool:
    r"""A word character for single_word tokens: Unicode `\w`, that is
    Alphabetic (L*, Nl, Other_Alphabetic), every mark, Nd, Pc and
    Join_Control. No (superscripts, fractions) is not a word character."""
    cat = unicodedata.category(c)
    if cat[0] in "LM" or cat in _WORD_CATEGORIES or c in "\u200c\u200d":
        return True
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _ALPHABETIC_SYMBOLS)


class _AddedVocab:
    """Added tokens split out of the text before the normalizer (those with
    normalized=False) and after it (normalized=True), leftmost-longest,
    honouring single_word, lstrip and rstrip."""

    def __init__(self, entries: list, model, normalizer) -> None:
        self.by_id: dict[int, str] = {}
        self.by_content: dict[str, int] = {}
        self.special: set[str] = set()
        self.options: dict[int, dict] = {}
        base = len(model.vocab)
        for e in entries:
            content = e["content"]
            if not content or content in self.by_content:
                continue
            tid = model.vocab.get(content)
            if tid is None:
                tid = max([base - 1, *self.by_id]) + 1
            self.by_id[tid] = content
            self.by_content[content] = tid
            if e.get("special", False):
                self.special.add(content)
            self.options[tid] = e
        self._raw = self._matcher(
            {c: t for c, t in self.by_content.items()
             if not self.options[t].get("normalized", True)}, None)
        self._normalized = self._matcher(
            {c: t for c, t in self.by_content.items()
             if self.options[t].get("normalized", True)}, normalizer)

    @staticmethod
    def _matcher(tokens: dict, normalizer):
        patterns = {}
        for content, tid in tokens.items():
            key = normalizer(content) if normalizer else content
            if key:
                patterns.setdefault(key, tid)
        if not patterns:
            return None
        ordered = sorted(patterns, key=len, reverse=True)
        return (re.compile("|".join(re.escape(p) for p in ordered)),
                patterns)

    def split(self, text: str, normalized: bool) -> list:
        """[(start, end, token id or None)] covering `text`."""
        matcher = self._normalized if normalized else self._raw
        if matcher is None or not text:
            return [(0, len(text), None)]
        compiled, patterns = matcher
        out, offset = [], 0
        for m in compiled.finditer(text):
            start, stop = m.start(), m.end()
            tid = patterns[m.group(0)]
            opts = self.options[tid]
            if opts.get("single_word", False):
                start_space = start == 0 or not _is_word_char(text[start - 1])
                stop_space = (stop == len(text)
                              or not _is_word_char(text[stop]))
                if not (start_space and stop_space):
                    continue
            if opts.get("lstrip", False):
                s = start
                while s > 0 and _is_space(text[s - 1]):
                    s -= 1
                start = max(s, offset)
            if opts.get("rstrip", False):
                while stop < len(text) and _is_space(text[stop]):
                    stop += 1
            if start < offset:
                continue  # inside the previous token's stripped spaces
            if offset < start:
                out.append((offset, start, None))
            out.append((start, stop, tid))
            offset = stop
        if offset != len(text):
            out.append((offset, len(text), None))
        return out


# -- the tokenizer ------------------------------------------------------------------


class HfTokenizer(Tokenizer):
    """A tokenizer.json (and its tokenizer_config.json /
    generation_config.json) interpreted as the `tokenizers` package runs
    it. `path` is the file or its directory."""

    def __init__(self, path: str) -> None:
        tok_file = path
        if os.path.isdir(path):
            tok_file = os.path.join(path, "tokenizer.json")
        self.file = tok_file
        try:
            with open(tok_file, encoding="utf-8") as f:
                spec = json.load(f)
        except ValueError as exc:
            raise ValueError(f"{tok_file} is not valid JSON: {exc}") from None
        try:
            self._build(spec)
        except UnsupportedTokenizer as exc:
            raise UnsupportedTokenizer(f"{tok_file}: {exc}") from None
        except (KeyError, TypeError) as exc:
            raise UnsupportedTokenizer(
                f"{tok_file}: malformed tokenizer ({exc!r})") from None
        self.eos_token_ids: list[int] = []
        self.chat_template: Optional[str] = None
        self._load_config(path if os.path.isdir(path)
                          else os.path.dirname(path))

    def _build(self, spec: dict) -> None:
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise UnsupportedTokenizer(f"{key} {spec[key]!r}")
        self._model = _build_model(spec["model"])
        self._normalizer = _build_normalizer(spec.get("normalizer"))
        self._pre_tokenizer = _build_pre_tokenizer(spec.get("pre_tokenizer"))
        self._decoder = _build_decoder(spec.get("decoder"))
        _check_post_processor(spec.get("post_processor"))
        self._added = _AddedVocab(spec.get("added_tokens") or [],
                                  self._model, self._normalizer)
        self.vocab_size = len(set(self._model.vocab.values())
                              | set(self._added.by_id))

    def _load_config(self, cfg_dir: str) -> None:
        """eos and chat_template from the sibling config files, as the
        reference reads them (a file that does not parse is skipped)."""
        tcfg_path = os.path.join(cfg_dir, "tokenizer_config.json")
        gcfg_path = os.path.join(cfg_dir, "generation_config.json")
        if os.path.exists(tcfg_path):
            try:
                with open(tcfg_path) as f:
                    tcfg = json.load(f)
                self.chat_template = tcfg.get("chat_template")
                eos = tcfg.get("eos_token")
                if isinstance(eos, dict):
                    eos = eos.get("content")
                if isinstance(eos, str):
                    tid = self.token_to_id(eos)
                    if tid is not None:
                        self.eos_token_ids.append(tid)
            except (OSError, ValueError):
                pass
        if os.path.exists(gcfg_path):
            try:
                with open(gcfg_path) as f:
                    gcfg = json.load(f)
                eos = gcfg.get("eos_token_id")
                if isinstance(eos, int):
                    eos = [eos]
                if isinstance(eos, list):
                    self.eos_token_ids.extend(
                        e for e in eos if e not in self.eos_token_ids)
            except (OSError, ValueError):
                pass

    # -- the pipeline ---------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for s, e, tid in self._added.split(text, normalized=False):
            if tid is not None:
                ids.append(tid)
                continue
            piece = text[s:e]
            at_start = s == 0
            if self._normalizer is not None:
                piece = self._normalizer(piece)
            for s2, e2, tid2 in self._added.split(piece, normalized=True):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                if e2 == s2:
                    continue
                pieces = [(piece[s2:e2], at_start and s2 == 0)]
                if self._pre_tokenizer is not None:
                    pieces = self._pre_tokenizer(pieces)
                for word, _ in pieces:
                    ids.extend(self._model.tokenize(word))
        return ids

    def decode(self, token_ids: Sequence[int]) -> str:
        tokens = []
        for tid in token_ids:
            tok = self.token_text(int(tid))
            if tok is None or tok in self._added.special:
                continue
            tokens.append(tok)
        if self._decoder is None:
            return " ".join(tokens)
        return "".join(self._decoder(tokens))

    def token_text(self, token_id: int) -> Optional[str]:
        tok = self._added.by_id.get(token_id)
        return tok if tok is not None else self._model.id_to_token.get(
            token_id)

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._added.by_content.get(token)
        return tid if tid is not None else self._model.vocab.get(token)
