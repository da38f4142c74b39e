"""Streaming tool-call parsers.

Extracts structured function calls from the generated text stream, per
format family, matching the reference's parser suite (ref: lib/parsers/
src/tool_calling/{json,pythonic,xml}/ and parsers.rs):

  hermes    — `<tool_call>{"name":..,"arguments":{..}}</tool_call>` blocks
              (Qwen/Hermes chat templates; ref xml + json hybrid parsers)
  mistral   — `[TOOL_CALLS] [{...}, ...]` marker + JSON array
  llama3    — the whole message is a JSON object
              `{"name":..,"parameters":{..}}` (llama3.1 json tool format)
  pythonic  — `[fn(a=1), other(b="x")]` call list parsed via ast
              (llama-4 / pythonic format, ref tool_calling/pythonic/)

Streaming model: `push(text)` returns plain content that is definitely not
part of a tool call; text from a (possible) marker onward is buffered.
Completed calls surface as ToolCall objects — per closed block for hermes,
at finalize for the whole-message formats (a JSON array is only valid when
complete, so earlier emission would be guesswork; the reference jails the
same way in chat_completions/jail.rs).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import uuid
from typing import Optional

from .reasoning import prefix_hold


@dataclasses.dataclass
class ToolCall:
    name: str
    arguments: str  # JSON-encoded arguments object
    id: str = dataclasses.field(
        default_factory=lambda: "call_" + uuid.uuid4().hex[:24])

    def to_openai(self, index: int) -> dict:
        return {"index": index, "id": self.id, "type": "function",
                "function": {"name": self.name, "arguments": self.arguments}}


@dataclasses.dataclass
class ToolEvent:
    content: str = ""
    calls: list[ToolCall] = dataclasses.field(default_factory=list)


def _call_from_obj(obj: dict) -> Optional[ToolCall]:
    if not isinstance(obj, dict) or "name" not in obj:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if isinstance(args, str):
        try:
            json.loads(args)
        except ValueError:
            args = json.dumps({"raw": args})
    else:
        args = json.dumps(args)
    return ToolCall(name=str(obj["name"]), arguments=args)


class _MarkerParser:
    """Shared machinery: pass content through until `marker` (jailing
    potential marker prefixes at the buffer tail), then buffer the rest."""

    marker: str = ""

    def __init__(self) -> None:
        self._buf = ""
        self._capturing = False
        self._capture = ""

    def push(self, text: str) -> ToolEvent:
        ev = ToolEvent()
        if self._capturing:
            self._capture += text
            self._on_capture(ev)
            return ev
        self._buf += text
        idx = self._buf.find(self.marker)
        if idx != -1:
            ev.content = self._buf[:idx]
            self._capture = self._buf[idx + len(self.marker):]
            self._buf = ""
            self._capturing = True
            self._on_capture(ev)
            return ev
        hold = prefix_hold(self._buf, self.marker)
        ev.content = self._buf[: len(self._buf) - hold]
        self._buf = self._buf[len(ev.content):]
        return ev

    def _on_capture(self, ev: ToolEvent) -> None:
        """Hook: formats that can close mid-stream emit calls here."""

    def finalize(self) -> ToolEvent:
        ev = ToolEvent()
        if self._capturing:
            self._finalize_capture(ev)
        else:
            ev.content = self._buf
        self._buf = ""
        self._capture = ""
        self._capturing = False
        return ev

    def _finalize_capture(self, ev: ToolEvent) -> None:
        raise NotImplementedError


class _BlockParser(_MarkerParser):
    """Marker...close blocks, emitted as each closes; content between
    blocks passes through. Subclasses provide `_parse_block`."""

    close = ""

    def _parse_block(self, block: str) -> Optional[ToolCall]:
        raise NotImplementedError

    def _on_capture(self, ev: ToolEvent) -> None:
        idx = self._capture.find(self.close)
        if idx == -1:
            return
        block = self._capture[:idx]
        rest = self._capture[idx + len(self.close):]
        call = self._parse_block(block)
        if call is not None:
            ev.calls.append(call)
        else:
            ev.content += self.marker + block + self.close
        # look for another block in the remainder
        self._capturing = False
        self._capture = ""
        follow = self.push(rest)
        ev.content += follow.content
        ev.calls.extend(follow.calls)

    def _finalize_capture(self, ev: ToolEvent) -> None:
        # Unterminated block: try parsing what we have; else emit raw.
        call = self._parse_block(self._capture)
        if call is not None:
            ev.calls.append(call)
        else:
            ev.content = self.marker + self._capture


class HermesToolParser(_BlockParser):
    """`<tool_call>{json}</tool_call>` blocks."""

    marker = "<tool_call>"
    close = "</tool_call>"

    def _parse_block(self, block: str) -> Optional[ToolCall]:
        try:
            return _call_from_obj(json.loads(block.strip()))
        except ValueError:
            return None


class MistralToolParser(_MarkerParser):
    """`[TOOL_CALLS] [{...}, ...]` — array parsed at finalize."""

    marker = "[TOOL_CALLS]"

    def _finalize_capture(self, ev: ToolEvent) -> None:
        try:
            data = json.loads(self._capture.strip())
        except ValueError:
            ev.content = self.marker + self._capture
            return
        if isinstance(data, dict):
            data = [data]
        for obj in data:
            call = _call_from_obj(obj)
            if call is not None:
                ev.calls.append(call)


class Llama3JsonToolParser:
    """The entire message is one JSON call object. Stream is jailed from
    the first `{`; decided at finalize."""

    def __init__(self) -> None:
        self._buf = ""
        self._maybe_json: Optional[bool] = None

    def push(self, text: str) -> ToolEvent:
        if self._maybe_json is None:
            probe = (self._buf + text).lstrip()
            if not probe:
                self._buf += text
                return ToolEvent()
            self._maybe_json = probe.startswith("{")
        self._buf += text
        if self._maybe_json:
            return ToolEvent()  # jail until finalize
        out, self._buf = self._buf, ""
        return ToolEvent(content=out)

    def finalize(self) -> ToolEvent:
        buf, self._buf = self._buf, ""
        if self._maybe_json:
            try:
                call = _call_from_obj(json.loads(buf.strip()))
                if call is not None:
                    return ToolEvent(calls=[call])
            except ValueError:
                pass
        return ToolEvent(content=buf)


class PythonicToolParser:
    """`[fn(a=1), g(x="y")]` — whole message, parsed with ast at finalize
    (ref tool_calling/pythonic/)."""

    def __init__(self) -> None:
        self._buf = ""
        self._maybe: Optional[bool] = None

    def push(self, text: str) -> ToolEvent:
        if self._maybe is None:
            probe = (self._buf + text).lstrip()
            if not probe:
                self._buf += text
                return ToolEvent()
            self._maybe = probe.startswith("[")
        self._buf += text
        if self._maybe:
            return ToolEvent()
        out, self._buf = self._buf, ""
        return ToolEvent(content=out)

    def finalize(self) -> ToolEvent:
        buf, self._buf = self._buf, ""
        if not self._maybe:
            return ToolEvent(content=buf)
        calls = self._parse(buf.strip())
        if calls is None:
            return ToolEvent(content=buf)
        return ToolEvent(calls=calls)

    @staticmethod
    def _parse(text: str) -> Optional[list[ToolCall]]:
        try:
            tree = ast.parse(text, mode="eval")
        except SyntaxError:
            return None
        if not isinstance(tree.body, ast.List):
            return None
        calls: list[ToolCall] = []
        for node in tree.body.elts:
            if not isinstance(node, ast.Call) or not isinstance(
                    node.func, ast.Name):
                return None
            args: dict = {}
            try:
                for kw in node.keywords:
                    args[kw.arg] = ast.literal_eval(kw.value)
                if node.args:
                    args["__positional__"] = [ast.literal_eval(a)
                                              for a in node.args]
            except ValueError:
                return None
            calls.append(ToolCall(name=node.func.id,
                                  arguments=json.dumps(args)))
        return calls


class XmlToolParser(_BlockParser):
    """Qwen3-Coder-style XML calls (ref: tool_calling/xml/):

        <tool_call>
        <function=get_weather>
        <parameter=city>
        Paris
        </parameter>
        </function>
        </tool_call>

    Parameters become string arguments (JSON-decoded when they parse as
    JSON scalars/objects, matching the reference's coercion)."""

    marker = "<tool_call>"
    close = "</tool_call>"

    _FN = re.compile(r"<function=([^>\s]+)>(.*?)</function>", re.DOTALL)
    _PARAM = re.compile(r"<parameter=([^>\s]+)>\n?(.*?)\n?</parameter>",
                        re.DOTALL)

    def _parse_block(self, block: str) -> Optional[ToolCall]:
        m = self._FN.search(block)
        if m is None:
            return None
        name, body = m.group(1), m.group(2)
        args: dict = {}
        for pm in self._PARAM.finditer(body):
            value = pm.group(2)
            try:
                args[pm.group(1)] = json.loads(value)
            except ValueError:
                args[pm.group(1)] = value
        return ToolCall(name=name, arguments=json.dumps(args))


class DsmlToolParser(_MarkerParser):
    """DeepSeek DSML calls (ref: tool_calling/dsml/):

        <｜tool▁calls▁begin｜><｜tool▁call▁begin｜>function<｜tool▁sep｜>NAME
        ```json
        {...}
        ```<｜tool▁call▁end｜>...<｜tool▁calls▁end｜>
    """

    marker = "<｜tool▁calls▁begin｜>"
    _CALL = re.compile(
        r"<｜tool▁call▁begin｜>\w*<｜tool▁sep｜>([^\n<]+)\n"
        r"```json\n(.*?)\n```\s*<｜tool▁call▁end｜>",
        re.DOTALL)

    def _finalize_capture(self, ev: ToolEvent) -> None:
        body = self._capture.split("<｜tool▁calls▁end｜>", 1)
        matched = False
        pos = 0
        for m in self._CALL.finditer(body[0]):
            # Anything between parsed calls (including a sibling whose JSON
            # is malformed/truncated) re-emits as content rather than
            # vanishing — the client must be able to see the broken call.
            leftover = body[0][pos:m.start()].strip()
            if leftover:
                ev.content += leftover
            pos = m.end()
            try:
                args = json.loads(m.group(2))
            except ValueError:
                ev.content += m.group(0)
                continue
            ev.calls.append(ToolCall(name=m.group(1).strip(),
                                     arguments=json.dumps(args)))
            matched = True
        if not matched:
            ev.content = self.marker + self._capture
            return
        tail = body[0][pos:].strip()
        if tail:
            ev.content += tail
        if len(body) > 1:
            ev.content += body[1]


class HarmonyToolParser:
    """gpt-oss Harmony channel format (ref: tool_calling/harmony/):

        <|channel|>analysis<|message|>...<|end|>
        <|channel|>commentary to=functions.NAME <|constrain|>json
            <|message|>{...}<|call|>
        <|channel|>final<|message|>VISIBLE TEXT<|return|>

    Streaming state machine: `final`-channel text streams through as it
    arrives (a Harmony answer always starts with channel markers — jailing
    until finalize would make streamed TTFT equal full generation time);
    `commentary to=functions.*` bodies become tool calls as each closes;
    `analysis` bodies are DROPPED here — configure the `harmony` reasoning
    parser (which runs first) to surface them as reasoning_content."""

    _MARKS = ("<|call|>", "<|end|>", "<|return|>")
    _TO_FN = re.compile(r"to=functions\.([\w.-]+)")
    _CHANNEL = "<|channel|>"
    _MESSAGE = "<|message|>"
    # Inter-message structure that must never leak into visible content:
    # role headers like <|start|>assistant and stray terminators.
    _STRUCT = re.compile(r"<\|start\|>[\w.-]*|<\|end\|>|<\|return\|>"
                         r"|<\|call\|>")
    _ALL_MARKS = ("<|channel|>", "<|message|>", "<|start|>", "<|end|>",
                  "<|return|>", "<|call|>")

    def __init__(self) -> None:
        self._buf = ""
        self._state = "text"  # text | header | body
        self._header = ""

    def _find_terminator(self) -> tuple[int, int]:
        """(index, len) of the earliest body terminator in the buffer."""
        best, blen = -1, 0
        for mark in self._MARKS:
            idx = self._buf.find(mark)
            if idx != -1 and (best == -1 or idx < best):
                best, blen = idx, len(mark)
        return best, blen

    def _emit_body(self, body: str, ev: ToolEvent) -> None:
        fn = self._TO_FN.search(self._header)
        if fn is not None:
            try:
                args = json.loads(body.strip())
            except ValueError:
                args = {"raw": body.strip()}
            ev.calls.append(ToolCall(name=fn.group(1),
                                     arguments=json.dumps(args)))
        # analysis/other non-final channels: dropped (see class docstring)

    def push(self, text: str) -> ToolEvent:
        ev = ToolEvent()
        self._buf += text
        while True:
            if self._state == "text":
                idx = self._buf.find(self._CHANNEL)
                if idx == -1:
                    hold = max(prefix_hold(self._buf, m)
                               for m in self._ALL_MARKS)
                    # Also hold a trailing '<|start|>rolename' whose role
                    # word may continue in the next chunk — stripping the
                    # complete marker now would leak the word's tail later.
                    tail = re.search(r"<\|start\|>[\w.-]*$", self._buf)
                    if tail is not None:
                        hold = max(hold, len(self._buf) - tail.start())
                    emit = self._buf[: len(self._buf) - hold]
                    ev.content += self._STRUCT.sub("", emit)
                    self._buf = self._buf[len(self._buf) - hold:]
                    return ev
                ev.content += self._STRUCT.sub("", self._buf[:idx])
                self._buf = self._buf[idx + len(self._CHANNEL):]
                self._state = "header"
            elif self._state == "header":
                idx = self._buf.find(self._MESSAGE)
                if idx == -1:
                    return ev
                self._header = self._buf[:idx]
                self._buf = self._buf[idx + len(self._MESSAGE):]
                self._state = "body"
            else:  # body
                is_final = self._header.strip().startswith("final")
                idx, tlen = self._find_terminator()
                if idx == -1:
                    if is_final:
                        # stream visible text now, jailing a possible
                        # terminator prefix at the tail
                        hold = max(prefix_hold(self._buf, m)
                                   for m in self._MARKS)
                        hold = max(hold, prefix_hold(self._buf,
                                                     self._CHANNEL))
                        ev.content += self._buf[: len(self._buf) - hold]
                        self._buf = self._buf[len(self._buf) - hold:]
                    return ev
                body = self._buf[:idx]
                self._buf = self._buf[idx + tlen:]
                if is_final:
                    ev.content += body
                else:
                    self._emit_body(body, ev)
                self._state = "text"

    def finalize(self) -> ToolEvent:
        ev = ToolEvent()
        buf, self._buf = self._buf, ""
        if self._state == "text":
            ev.content = self._STRUCT.sub("", buf)
        elif self._state == "header":
            ev.content = self._CHANNEL + buf  # malformed: re-emit raw
        else:  # unterminated body (generation hit max_tokens)
            if self._header.strip().startswith("final"):
                ev.content = buf
            else:
                self._emit_body(buf, ev)
        self._state = "text"
        self._header = ""
        return ev


TOOL_PARSERS = {
    "hermes": HermesToolParser,
    "qwen": HermesToolParser,  # qwen templates use hermes format
    "mistral": MistralToolParser,
    "llama3_json": Llama3JsonToolParser,
    "pythonic": PythonicToolParser,
    "xml": XmlToolParser,
    "dsml": DsmlToolParser,
    "harmony": HarmonyToolParser,
}


def make_tool_parser(name: str):
    if not name:
        return None
    try:
        return TOOL_PARSERS[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown tool parser {name!r}; "
                         f"one of {sorted(TOOL_PARSERS)}")
