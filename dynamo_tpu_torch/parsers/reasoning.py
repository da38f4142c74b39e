"""Streaming reasoning-content parsers.

Splits a token-text stream into `reasoning_content` vs `content` the way
the reference's reasoning parsers do (ref: lib/parsers/src/reasoning/
base_parser.rs + gpt_oss/granite/minimax variants): a `<think>`-style
span is routed to the OpenAI `reasoning_content` delta field, everything
after the close tag to `content`. Partial tags at a chunk boundary are
jailed (held back) until disambiguated — the same mechanism as stop-string
jailing.

`starts_in_reasoning` covers models that open the stream already inside a
think block without emitting the open tag (ref minimax_append_think_parser
.rs; DeepSeek-R1 behaves this way with some templates).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def prefix_hold(buf: str, tag: str) -> int:
    """Longest proper prefix of `tag` that `buf` ends with — the amount of
    trailing text a streaming parser must hold back because it may be the
    start of `tag` (shared by reasoning + tool-call jailing)."""
    for k in range(min(len(tag) - 1, len(buf)), 0, -1):
        if buf.endswith(tag[:k]):
            return k
    return 0


@dataclasses.dataclass
class ReasoningEvent:
    reasoning: str = ""
    content: str = ""


class StreamingReasoningParser:
    def __init__(self, open_tag: str = "<think>",
                 close_tag: str = "</think>",
                 starts_in_reasoning: bool = False,
                 recurring: bool = False) -> None:
        self.open_tag = open_tag
        self.close_tag = close_tag
        # recurring: after a span closes, look for the NEXT open tag
        # instead of treating the rest as content (Harmony emits multiple
        # analysis spans interleaved with tool calls).
        self.recurring = recurring
        self._state = "reasoning" if starts_in_reasoning else "before"
        self._buf = ""

    def push(self, text: str) -> ReasoningEvent:
        ev = ReasoningEvent()
        self._buf += text
        while self._buf:
            if self._state == "before":
                idx = self._buf.find(self.open_tag)
                if idx != -1:
                    ev.content += self._buf[:idx]
                    self._buf = self._buf[idx + len(self.open_tag):]
                    self._state = "reasoning"
                    continue
                hold = prefix_hold(self._buf, self.open_tag)
                emit = self._buf[: len(self._buf) - hold]
                ev.content += emit
                self._buf = self._buf[len(emit):]
                break
            if self._state == "reasoning":
                idx = self._buf.find(self.close_tag)
                if idx != -1:
                    ev.reasoning += self._buf[:idx]
                    self._buf = self._buf[idx + len(self.close_tag):]
                    self._state = "before" if self.recurring else "after"
                    continue
                hold = prefix_hold(self._buf, self.close_tag)
                emit = self._buf[: len(self._buf) - hold]
                ev.reasoning += emit
                self._buf = self._buf[len(emit):]
                break
            # after: everything is content
            ev.content += self._buf
            self._buf = ""
        return ev

    def finalize(self) -> ReasoningEvent:
        """Flush jailed text; an unterminated think block counts as
        reasoning (the model ran out of budget mid-thought)."""
        buf, self._buf = self._buf, ""
        if self._state == "reasoning":
            return ReasoningEvent(reasoning=buf)
        return ReasoningEvent(content=buf)


REASONING_PARSERS = {
    # canonical <think> (qwen3, deepseek-r1 templates that emit the tag)
    "think": lambda: StreamingReasoningParser(),
    "deepseek-r1": lambda: StreamingReasoningParser(starts_in_reasoning=True),
    # granite-style response separator (ref granite_parser.rs)
    "granite": lambda: StreamingReasoningParser(
        open_tag="Here is my thought process:",
        close_tag="Here is my response:"),
    # gpt-oss Harmony: the analysis channel is the reasoning stream (ref
    # reasoning/gpt_oss parser). Pairs with the `harmony` tool parser,
    # which then consumes the remaining channel structure.
    "harmony": lambda: StreamingReasoningParser(
        open_tag="<|channel|>analysis<|message|>",
        close_tag="<|end|>", recurring=True),
    "gpt-oss": lambda: StreamingReasoningParser(
        open_tag="<|channel|>analysis<|message|>",
        close_tag="<|end|>", recurring=True),
}


def make_reasoning_parser(name: str) -> Optional[StreamingReasoningParser]:
    if not name:
        return None
    try:
        return REASONING_PARSERS[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown reasoning parser {name!r}; "
                         f"one of {sorted(REASONING_PARSERS)}")
