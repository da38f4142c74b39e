"""OpenAI preprocessor: request lowering and response delta generation.

Port of `dynamo_tpu/llm/preprocessor.py`. Forward edge: apply the chat
template -> tokenize -> PreprocessedRequest with sampling + stop conditions
(ref: lib/llm/src/preprocessor.rs:147,225). Backward edge: incremental
detokenization + OpenAI SSE delta construction with stop-string jailing —
text that might be a prefix of a stop string is held until disambiguated
(ref: backend.rs detokenizer + http delta path, chat_completions/jail.rs).

The card's or the tokenizer's chat template, or without one the
reference's default (ChatML), is rendered by `llm/chat_template.py` (the
part of Jinja that HF templates use, with jinja2's semantics). A template
outside the renderer's
grammar is refused when the preprocessor is built: chat requests then
answer 400 and completions still serve. A template that fails while it
renders (an undefined `raise_exception`, say) raises its `TemplateError`,
which the HTTP service answers as the reference's server answers an
uncaught jinja2 error. Structured outputs (`response_format`,
`nvext.guided_decoding`, `tool_choice` forcing) lower to the worker's
'guided' logits processor (`llm/guided.py`); chat responses go through the
card's tool and reasoning parsers (`parsers/`). Not ported yet: multimodal
prompts.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..engine.sampler import TOP_LOGPROBS_K
from ..parsers import make_reasoning_parser, make_tool_parser
from .chat_template import ChatTemplate, TemplateSyntaxError
from .model_card import ModelDeploymentCard
from .protocols import (
    EngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
    new_request_id,
    normalize_priority,
    now_unix,
    openai_chunk_id,
)
from .tokenizer import IncrementalDetokenizer, Tokenizer, load_tokenizer
from .validate import RequestError, validate_logit_bias, validate_request

log = logging.getLogger("dynamo_tpu_torch.preprocessor")

# ChatML — the de-facto default template when a model ships none (the
# reference renders this string with jinja2).
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|im_start|>{{ message['role'] }}\n{{ message['content'] }}<|im_end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


class OpenAIPreprocessor:
    def __init__(self, card: ModelDeploymentCard,
                 tokenizer: Optional[Tokenizer] = None) -> None:
        self.card = card
        self.tokenizer = tokenizer or load_tokenizer(card.tokenizer)
        source = (card.chat_template or self.tokenizer.chat_template
                  or DEFAULT_CHAT_TEMPLATE)
        self.template: Optional[ChatTemplate] = None
        self.template_refused: Optional[str] = None
        try:
            self.template = ChatTemplate(source)
        except TemplateSyntaxError as exc:
            self.template_refused = (
                f"model '{card.name}' has a chat template outside the "
                f"renderer's grammar ({exc})")
            log.warning("%s; chat requests will answer 400",
                        self.template_refused)

    # -- forward: OpenAI request -> PreprocessedRequest --------------------

    def render_chat(self, messages: list[dict]) -> str:
        if self.template_refused:
            raise RequestError(self.template_refused)
        for msg in messages:
            if not isinstance(msg, dict) or "role" not in msg:
                raise RequestError("each message needs a 'role'")
            content = msg.get("content")
            if isinstance(content, list):
                # Content parts: concatenate the text parts.
                msg["content"] = "".join(
                    part.get("text", "") for part in content
                    if isinstance(part, dict) and part.get("type") == "text"
                )
        return self.template.render(messages=messages,
                                    add_generation_prompt=True)

    def preprocess_chat(self, request: dict) -> PreprocessedRequest:
        validate_request(request, "chat")
        messages = request.get("messages")
        if not messages:
            raise RequestError("'messages' is required and must be non-empty")
        if any(isinstance(m.get("content"), list)
               and any(isinstance(p, dict) and p.get("type") == "image_url"
                       for p in m["content"])
               for m in messages if isinstance(m, dict)):
            # No card of this package advertises multimodal input.
            raise RequestError(
                f"model '{self.card.name}' does not accept image input")
        prompt = self.render_chat(list(messages))
        return self._build(prompt, request)

    def preprocess_completions(self, request: dict) -> PreprocessedRequest:
        validate_request(request, "completions")
        prompt = request.get("prompt")
        if prompt is None:
            raise RequestError("'prompt' is required")
        if isinstance(prompt, list):
            if prompt and isinstance(prompt[0], int):
                return self._build_from_tokens([int(t) for t in prompt],
                                               request)
            if len(prompt) == 1:
                prompt = prompt[0]
            else:
                # OpenAI batch-prompt semantics (one choice per prompt) are
                # not supported; rejecting beats silently concatenating.
                raise RequestError(
                    "batched string prompts are not supported; send one "
                    "prompt per request"
                )
        return self._build(str(prompt), request)

    def _build(self, prompt: str, request: dict) -> PreprocessedRequest:
        return self._build_from_tokens(self.tokenizer.encode(prompt), request)

    def _build_from_tokens(self, token_ids: list[int], request: dict) -> PreprocessedRequest:
        max_context = self.card.context_length
        if len(token_ids) >= max_context:
            raise RequestError(
                f"prompt ({len(token_ids)} tokens) exceeds the model context "
                f"length ({max_context})"
            )
        max_tokens = request.get("max_completion_tokens") or request.get("max_tokens")
        if max_tokens is None:
            max_tokens = min(self.card.max_output_tokens,
                             max_context - len(token_ids))
        max_tokens = min(int(max_tokens), max_context - len(token_ids))
        if max_tokens <= 0:
            raise RequestError("max_tokens must be positive within context length")

        stop = request.get("stop")
        if stop is None:
            stop_strings = []
        elif isinstance(stop, str):
            stop_strings = [stop]
        else:
            stop_strings = [str(s) for s in stop][:8]

        sampling = SamplingOptions(
            max_tokens=max_tokens,
            temperature=float(request.get("temperature", 1.0) or 0.0),
            top_p=float(request.get("top_p", 1.0) or 1.0),
            top_k=int(request.get("top_k", 0) or 0),
            seed=request.get("seed"),
            frequency_penalty=float(request.get("frequency_penalty", 0.0) or 0.0),
            presence_penalty=float(request.get("presence_penalty", 0.0) or 0.0),
            repetition_penalty=float(
                request.get("repetition_penalty", 1.0) or 1.0),
            min_p=float(request.get("min_p", 0.0) or 0.0),
            logprobs=bool(request.get("logprobs", False)),
            top_logprobs=int(request.get("top_logprobs", 0) or 0),
            logit_bias=validate_logit_bias(request.get("logit_bias")),
        )
        # Completions-style `logprobs: N` (an int, not the chat bool) also
        # requests N alternatives per token.
        lp_req = request.get("logprobs", False)
        if isinstance(lp_req, int) and not isinstance(lp_req, bool):
            # Completions-style integer: logprobs: 0 still returns the
            # sampled token's logprob (with zero alternatives).
            sampling.logprobs = True
            sampling.top_logprobs = max(sampling.top_logprobs, int(lp_req))
        if sampling.top_logprobs > TOP_LOGPROBS_K:
            # The engine returns a fixed top-K per step; silently truncating
            # would hand back a distribution that looks complete but isn't.
            raise RequestError(
                f"top_logprobs={sampling.top_logprobs} exceeds the engine "
                f"maximum of {TOP_LOGPROBS_K}")
        try:
            # Multi-tenant QoS wire surface (docs/multi-tenancy.md): the
            # body `priority` field (the x-dynt-priority header is folded
            # into the body by the HTTP layer before preprocessing) and
            # the tenant identity, normalized once here so every queue
            # downstream sees a validated class.
            priority = normalize_priority(request.get("priority"))
        except ValueError as exc:
            raise RequestError(str(exc))
        pre = PreprocessedRequest(
            request_id=new_request_id(),
            token_ids=token_ids,
            sampling=sampling,
            stop=StopConditions(
                stop_token_ids=[],
                stop_strings=stop_strings,
                ignore_eos=bool(request.get("ignore_eos", False)),
                min_tokens=int(request.get("min_tokens", 0) or 0),
            ),
            eos_token_ids=list(self.tokenizer.eos_token_ids),
            model=request.get("model", self.card.name),
            priority=priority,
            # Tenant ids become Prometheus label values: bound the
            # per-request blast radius (strip + truncate). Cardinality
            # itself is the operator's contract — tenant ids should be
            # a bounded, authenticated set (docs/multi-tenancy.md).
            tenant=str(request.get("tenant") or "").strip()[:64],
        )
        nvext = request.get("nvext")
        if isinstance(nvext, dict):
            if isinstance(nvext.get("annotations"), dict):
                pre.annotations.update(nvext["annotations"])
            if nvext.get("priority") is not None:
                pre.annotations["priority"] = nvext["priority"]
            if nvext.get("logits_processors"):
                pre.logits_processors = list(nvext["logits_processors"])
            if nvext.get("guided_decoding"):
                # reference protocol (common.rs GuidedDecodingOptions):
                # exactly one of json / regex / choice is set (validated
                # in llm/validate.py); enforced by the engine-side
                # 'guided' processor (llm/guided.py)
                gd = dict(nvext["guided_decoding"])
                args = {}
                if gd.get("regex") is not None:
                    args["regex"] = gd["regex"]
                elif gd.get("choice") is not None:
                    args["choice"] = list(gd["choice"])
                elif gd.get("json") is not None:
                    js = gd["json"]
                    if js is True or js == "object":
                        args["json_object"] = True
                    else:
                        args["json_schema"] = js
                pre.logits_processors.append(
                    {"name": "guided", "args": args})
        rf = request.get("response_format")
        if isinstance(rf, dict) and rf.get("type") in ("json_object",
                                                       "json_schema"):
            # OpenAI structured outputs ride the same guided processor
            args = {"json_object": True}
            if rf.get("type") == "json_schema":
                schema = (rf.get("json_schema") or {}).get("schema")
                if schema is not None:
                    # {} stays a schema: it permits ANY value, which is
                    # WEAKER than json_object's top-level-object rule
                    args = {"json_schema": schema}
            pre.logits_processors.append({"name": "guided", "args": args})
        tc = request.get("tool_choice")
        forced_name = None
        force_tools = False
        if tc == "required":
            force_tools = True
        elif isinstance(tc, dict) and tc.get("type") == "function":
            force_tools = True
            forced_name = (tc.get("function") or {}).get("name")
        if force_tools:
            # OpenAI tool_choice forcing: constrain the output to a
            # declared function call in the model's tool-parser format
            # (validated in llm/validate.py; the grammar is built by
            # guided.tool_call_regex so the parser extracts it).
            if not self.card.tool_parser:
                raise RequestError(
                    "tool_choice forcing needs a model served with a "
                    "tool parser (--tool-call-parser)")
            if self.card.tool_parser.lower() not in (
                    "hermes", "qwen", "llama3_json", "mistral"):
                # reject HERE (-> 400), not at engine grammar-build time
                raise RequestError(
                    "tool_choice forcing is not supported for tool "
                    f"parser {self.card.tool_parser!r} (hermes/qwen, "
                    "llama3_json, mistral)")
            pre.logits_processors.append({"name": "guided", "args": {
                "tool_call": {"format": self.card.tool_parser,
                              "tools": request.get("tools") or [],
                              "name": forced_name}}})
        return pre


class DeltaGenerator:
    """Backward edge: EngineOutput stream -> OpenAI SSE chunk dicts, with
    incremental detokenization, stop-string jailing and, for chat, the
    reasoning and tool-call parsers."""

    def __init__(
        self,
        preprocessor: OpenAIPreprocessor,
        request: PreprocessedRequest,
        kind: str = "chat",  # chat | completions
        tool_parser: Optional[str] = None,
        reasoning_parser: Optional[str] = None,
    ) -> None:
        self.pre = preprocessor
        self.request = request
        self.kind = kind
        self.chunk_id = openai_chunk_id()
        self.created = now_unix()
        self.detok = IncrementalDetokenizer(preprocessor.tokenizer)
        self.completion_tokens = 0
        self.finish_reason: Optional[str] = None
        self.stop_sequence_hit: Optional[str] = None  # the stop that fired
        self._jail = ""  # text held back: may be a prefix of a stop string
        self._stopped = False
        self._role_sent = False
        self.full_text = ""
        self.full_reasoning = ""
        self.tool_calls: list = []
        # OpenAI-shape logprob entries, one per generated token (populated
        # only when the request asked for logprobs)
        self.logprob_entries: list[dict] = []
        # Output parsers (chat only; ref: chat_completions/jail.rs wiring)
        self._reasoning = (make_reasoning_parser(reasoning_parser)
                           if kind == "chat" else None)
        self._tools = (make_tool_parser(tool_parser)
                       if kind == "chat" else None)

    # stop-string handling ------------------------------------------------

    def _filter_stop(self, text: str, final: bool) -> tuple[str, bool]:
        """Returns (emit_text, hit_stop). Holds back possible stop prefixes."""
        stops = self.request.stop.stop_strings
        if not stops:
            return text, False
        buf = self._jail + text
        # Full stop match?
        earliest = None
        for stop in stops:
            idx = buf.find(stop)
            if idx != -1 and (earliest is None or idx < earliest):
                earliest = idx
                self.stop_sequence_hit = stop
        if earliest is not None:
            self._jail = ""
            return buf[:earliest], True
        if final:
            self._jail = ""
            return buf, False
        # Hold back the longest tail that is a proper prefix of any stop.
        hold = 0
        for stop in stops:
            for k in range(min(len(stop) - 1, len(buf)), 0, -1):
                if buf.endswith(stop[:k]):
                    hold = max(hold, k)
                    break
        self._jail = buf[len(buf) - hold :] if hold else ""
        return buf[: len(buf) - hold] if hold else buf, False

    # chunk construction --------------------------------------------------

    def _chunk(self, delta: dict, finish_reason: Optional[str]) -> dict:
        if self.kind == "chat":
            return {
                "id": self.chunk_id,
                "object": "chat.completion.chunk",
                "created": self.created,
                "model": self.request.model,
                "choices": [{
                    "index": 0,
                    "delta": delta,
                    "finish_reason": finish_reason,
                }],
            }
        return {
            "id": self.chunk_id,
            "object": "text_completion",
            "created": self.created,
            "model": self.request.model,
            "choices": [{
                "index": 0,
                "text": delta.get("content", ""),
                "finish_reason": finish_reason,
            }],
        }

    def _route(self, text: str, final: bool) -> list[dict]:
        """Route emitted text through the reasoning and tool parsers into
        OpenAI delta dicts (ref: parsers crate via chat_completions/jail.rs)."""
        deltas: list[dict] = []
        reason_text, content_text = "", text
        if self._reasoning is not None:
            ev = self._reasoning.push(text)
            if final:
                fin = self._reasoning.finalize()
                ev.reasoning += fin.reasoning
                ev.content += fin.content
            reason_text, content_text = ev.reasoning, ev.content
        if reason_text:
            self.full_reasoning += reason_text
            deltas.append({"reasoning_content": reason_text})
        if self._tools is not None:
            tev = self._tools.push(content_text)
            if final:
                fin = self._tools.finalize()
                tev.content += fin.content
                tev.calls.extend(fin.calls)
            if tev.content:
                self.full_text += tev.content
                deltas.append({"content": tev.content})
            if tev.calls:
                start = len(self.tool_calls)
                payload = [c.to_openai(start + i)
                           for i, c in enumerate(tev.calls)]
                self.tool_calls.extend(tev.calls)
                deltas.append({"tool_calls": payload})
        elif content_text:
            self.full_text += content_text
            deltas.append({"content": content_text})
        return deltas

    def _final_reason(self, reason: str) -> str:
        return ("tool_calls" if (self.tool_calls and reason == "stop")
                else reason)

    def on_output(self, output: EngineOutput) -> list[dict]:
        """Convert one engine item into zero or more SSE chunks."""
        if self._stopped:
            return []
        chunks: list[dict] = []
        if output.error:
            self.finish_reason = "error"
            self._stopped = True
            return [self._chunk({}, "error")]
        self.completion_tokens += len(output.token_ids)
        final = output.finish_reason is not None
        ids = output.token_ids
        trimmed_eos = (output.finish_reason == "stop" and ids
                       and (ids[-1] in self.request.eos_token_ids
                            or ids[-1] in self.request.stop.stop_token_ids))
        if trimmed_eos:
            # the terminating eos/stop TOKEN is not content (HF
            # tokenizers render it as "" via skip_special_tokens, but
            # e.g. the byte tokenizer names its specials)
            ids = ids[:-1]
        new_lp_entries: list[dict] = []
        if output.logprobs is not None:
            before = len(self.logprob_entries)
            self._collect_logprobs(output)
            new_lp_entries = self.logprob_entries[before:]
            if trimmed_eos and new_lp_entries:
                # keep logprob entries 1:1 with CONTENT tokens (OpenAI
                # emits no entry for the stop token)
                new_lp_entries.pop()
                self.logprob_entries.pop()
        text = self.detok.push(ids)
        if final:
            text += self.detok.flush()
        emit, hit_stop = self._filter_stop(text, final)
        for delta in self._route(emit, final or hit_stop):
            if self.kind == "chat" and not self._role_sent:
                delta["role"] = "assistant"
                self._role_sent = True
            chunks.append(self._chunk(delta, None))
        if hit_stop:
            self.finish_reason = self._final_reason("stop")
            self._stopped = True
            chunks.append(self._chunk({}, self.finish_reason))
        elif final:
            self.finish_reason = self._final_reason(output.finish_reason)
            self._stopped = True
            chunks.append(self._chunk({}, self.finish_reason))
        if new_lp_entries and chunks:
            # Streamed logprobs ride the first chunk of this engine item
            # (token-aligned; OpenAI streams them per chunk the same way).
            if self.kind == "chat":
                chunks[0]["choices"][0]["logprobs"] = {
                    "content": new_lp_entries}
            else:
                chunks[0]["choices"][0]["logprobs"] = \
                    self._completions_lp_block(new_lp_entries)
        return chunks

    def _collect_logprobs(self, output) -> None:
        decode = self.pre.tokenizer.decode
        for j, tid in enumerate(output.token_ids):
            entry = {
                "token": decode([tid]),
                "logprob": float(output.logprobs[j]),
            }
            if output.top_logprobs:
                entry["top_logprobs"] = [
                    {"token": decode([int(alt_id)]),
                     "logprob": float(alt_lp)}
                    for alt_id, alt_lp in output.top_logprobs[j]
                ]
            self.logprob_entries.append(entry)

    @staticmethod
    def _completions_lp_block(entries: list[dict]) -> dict:
        return {
            "tokens": [e["token"] for e in entries],
            "token_logprobs": [e["logprob"] for e in entries],
            "top_logprobs": [
                {alt["token"]: alt["logprob"]
                 for alt in e.get("top_logprobs", [])} or None
                for e in entries
            ],
        }

    def logprobs_block(self):
        """OpenAI response logprobs object for this stream, or None."""
        if not self.logprob_entries:
            return None
        if self.kind == "chat":
            return {"content": self.logprob_entries}
        return self._completions_lp_block(self.logprob_entries)

    def usage(self) -> dict:
        return {
            "prompt_tokens": len(self.request.token_ids),
            "completion_tokens": self.completion_tokens,
            "total_tokens": len(self.request.token_ids) + self.completion_tokens,
        }

    def final_response(self) -> dict:
        """Non-streaming aggregate response."""
        if self.kind == "chat":
            message: dict = {"role": "assistant", "content": self.full_text}
            if self.full_reasoning:
                message["reasoning_content"] = self.full_reasoning
            if self.tool_calls:
                message["tool_calls"] = [
                    {k: v for k, v in c.to_openai(i).items() if k != "index"}
                    for i, c in enumerate(self.tool_calls)]
                if not self.full_text:
                    message["content"] = None
            choice = {
                "index": 0,
                "message": message,
                "finish_reason": self.finish_reason or "stop",
            }
            if self.logprob_entries:
                choice["logprobs"] = self.logprobs_block()
            return {
                "id": self.chunk_id,
                "object": "chat.completion",
                "created": self.created,
                "model": self.request.model,
                "choices": [choice],
                "usage": self.usage(),
            }
        choice = {
            "index": 0,
            "text": self.full_text,
            "finish_reason": self.finish_reason or "stop",
        }
        if self.logprob_entries:
            choice["logprobs"] = self.logprobs_block()
        return {
            "id": self.chunk_id,
            "object": "text_completion",
            "created": self.created,
            "model": self.request.model,
            "choices": [choice],
            "usage": self.usage(),
        }
