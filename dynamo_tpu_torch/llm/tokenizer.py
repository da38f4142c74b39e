"""Tokenizer abstraction: the byte-level tokenizer, HF tokenizers and
streaming decode.

Port of `dynamo_tpu/llm/tokenizer.py`. `ByteTokenizer` (256 byte vocab +
special tokens; zero-asset) is what the workers of both packages advertise
on their cards for random-weight presets; a worker serving a checkpoint
directory with a `tokenizer.json` advertises {"kind": "hf", "path": dir},
which `load_tokenizer` builds as `llm.hf_tokenizer.HfTokenizer` (the file
interpreted on the standard library, as the `tokenizers` package runs it).

Incremental (streaming) detokenization uses the prefix-offset technique: keep
decoding the tail window of tokens and only emit the stable UTF-8 suffix, so
multi-token unicode renders correctly.
"""

from __future__ import annotations

from typing import Optional, Sequence


class Tokenizer:
    eos_token_ids: list[int] = []
    vocab_size: int = 0
    chat_template: Optional[str] = None
    # How many trailing tokens may still merge with future tokens when
    # decoding incrementally (BPE merges / sentencepiece boundary spaces).
    # Byte-level decode is prefix-stable, so 0 there.
    stable_window: int = 4

    def encode(self, text: str) -> list[int]:
        raise NotImplementedError

    def decode(self, token_ids: Sequence[int]) -> str:
        raise NotImplementedError

    def token_text(self, token_id: int) -> Optional[str]:
        """Raw vocab string of one token (e.g. 'Ġhello', 'â' for a lone
        UTF-8 continuation byte under byte-level BPE), or None if
        unknown. Unlike decode(), never lossy: guided decoding inverts
        byte-level-BPE strings back to true bytes (llm/guided.py)."""
        return None


class ByteTokenizer(Tokenizer):
    """Byte-level: token i (< 256) is byte i. Special tokens above 255.
    Mirrors the role of the mocker's tokenizer-free operation."""

    BOS = 256
    EOS = 257
    PAD = 258
    IM_START = 259
    IM_END = 260

    SPECIALS = {BOS: "<s>", EOS: "</s>", PAD: "<pad>",
                IM_START: "<|im_start|>", IM_END: "<|im_end|>"}

    def __init__(self) -> None:
        self.eos_token_ids = [self.EOS, self.IM_END]
        self.vocab_size = 512  # headroom above 261 for model round numbers
        self.stable_window = 0

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, token_ids: Sequence[int]) -> str:
        out: list[str] = []
        buf = bytearray()
        for tok in token_ids:
            if tok < 256:
                buf.append(tok)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf.clear()
                out.append(self.SPECIALS.get(tok, f"<unk:{tok}>"))
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


def load_tokenizer(spec: dict) -> Tokenizer:
    kind = spec.get("kind", "byte")
    if kind == "byte":
        return ByteTokenizer()
    if kind == "hf":
        from .hf_tokenizer import HfTokenizer

        return HfTokenizer(spec["path"])
    raise ValueError(f"unknown tokenizer spec: {spec!r}")


class IncrementalDetokenizer:
    """Streaming decode: emits only text that can no longer change as more
    tokens arrive (ref: Backend detokenizer hot loop, lib/llm/src/backend.rs).

    Per-token cost is O(window): we decode a sliding tail window anchored at
    `_ctx_start` and diff against the previously decoded length, instead of
    re-decoding the whole sequence (the reference's Rust hot loop does the
    same prefix-offset trick). The anchor slides forward periodically so the
    decoded span stays bounded."""

    # Keep this many already-stable tokens as decode context when sliding the
    # anchor (BPE/sentencepiece boundary effects cancel within the context).
    _CTX_KEEP = 16
    # Slide the anchor once the decoded span exceeds this many tokens.
    _CTX_MAX = 256

    def __init__(self, tokenizer: Tokenizer, window: Optional[int] = None) -> None:
        self._tok = tokenizer
        self._ids: list[int] = []
        self._window = tokenizer.stable_window if window is None else window
        self._ctx_start = 0  # decode-anchor token index
        self._stable_tokens = 0  # tokens whose text has been emitted
        self._prev_len = 0  # len(decode(ids[_ctx_start:_stable_tokens])) - held-back "�"

    def push(self, token_ids: Sequence[int]) -> str:
        """Add tokens, return newly-stable text (may be '')."""
        self._ids.extend(token_ids)
        n = len(self._ids)
        stable = n if self._window == 0 else max(0, n - self._window)
        if stable <= self._stable_tokens:
            return ""
        text = self._tok.decode(self._ids[self._ctx_start : stable])
        candidate = text[self._prev_len :]
        # Never emit a trailing replacement char (partial UTF-8 sequence);
        # it re-decodes complete once the rest of the char arrives.
        while candidate.endswith("�"):
            candidate = candidate[:-1]
        self._stable_tokens = stable
        self._prev_len += len(candidate)
        if stable - self._ctx_start > self._CTX_MAX:
            self._ctx_start = max(0, stable - self._CTX_KEEP)
            anchored = self._tok.decode(self._ids[self._ctx_start : stable])
            while anchored.endswith("�"):  # keep held-back partial chars held
                anchored = anchored[:-1]
            self._prev_len = len(anchored)
        return candidate

    def flush(self) -> str:
        """Emit everything outstanding (end of stream)."""
        full = self._tok.decode(self._ids[self._ctx_start :])
        out = full[self._prev_len :]
        self._prev_len = len(full)
        self._stable_tokens = len(self._ids)
        return out
