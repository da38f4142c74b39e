"""OpenAI request validation: unsupported-field tracking + range checks.

Copy of `dynamo_tpu/llm/validate.py`, with the same 400 messages. Unknown
request fields are rejected with 400 "Unsupported parameter" instead of
being silently dropped (ref: lib/llm/src/protocols/openai/{completions.rs:44,
422,validate.rs:101}); known fields get the reference's range checks
(validate.rs temperature/top_p/penalties/logit_bias/n): a client sending
`response_format` for JSON mode must get it honoured or a 400, never
confidently unconstrained output. Penalties, logit_bias, min_p, min_tokens,
guided decoding (`response_format`, `nvext.guided_decoding`) and
`tool_choice` forcing are served by the worker's logits processors; an EBNF
`grammar` answers 400 here, as in the reference.
"""

from __future__ import annotations

from typing import Any, Optional


class RequestError(ValueError):
    """Invalid user request -> HTTP 400."""


# Fields consumed by the preprocessor/HTTP layer for each endpoint kind.
# Anything else in the request body is an unsupported parameter.
_COMMON_FIELDS = {
    "model", "stream", "stream_options", "max_tokens",
    "max_completion_tokens", "temperature", "top_p", "top_k", "seed",
    "frequency_penalty", "presence_penalty", "repetition_penalty",
    "min_p", "min_tokens", "logprobs", "top_logprobs",
    "stop", "ignore_eos", "n", "user", "logit_bias", "metadata", "nvext",
    # Multi-tenant QoS (docs/multi-tenancy.md): priority class
    # (interactive | standard | batch; value validated in the
    # preprocessor) and tenant identity. Top-level on every
    # completion-shaped endpoint; the x-dynt-priority /
    # x-dynt-tenant-id headers fold into these fields.
    "priority", "tenant",
}
CHAT_FIELDS = _COMMON_FIELDS | {
    "messages", "tools", "tool_choice", "response_format",
    "parallel_tool_calls",
    # Session tier (docs/prompt-caching.md): session affinity id and a
    # whole-prompt cache marker. Accepted regardless of
    # DYNT_SESSION_ENABLE — the operator switch must not turn existing
    # clients' requests into 400s; per-message cache_control markers
    # live inside message/content dicts and are not top-level fields.
    "session_id", "cache_control",
}
COMPLETION_FIELDS = _COMMON_FIELDS | {"prompt", "echo", "suffix"}

# nvext is our extension namespace (the reference's NvExt analog).
NVEXT_FIELDS = {"annotations", "priority", "logits_processors",
                "guided_decoding"}


def _reject_unknown(body: dict, allowed: set) -> None:
    unknown = sorted(k for k in body if k not in allowed)
    if unknown:
        raise RequestError(
            "Unsupported parameter: "
            + ", ".join(f"'{k}'" for k in unknown))


def _check_range(body: dict, field: str, lo: float, hi: float) -> None:
    val = body.get(field)
    if val is None:
        return
    try:
        f = float(val)
    except (TypeError, ValueError):
        raise RequestError(f"'{field}' must be a number") from None
    if not (lo <= f <= hi):
        raise RequestError(
            f"'{field}' must be between {lo} and {hi}, got {f}")


def validate_logit_bias(raw: Any) -> Optional[dict[int, float]]:
    """OpenAI logit_bias: {token_id: bias in [-100, 100]}. Returns the
    parsed map (int keys) or None."""
    if raw is None:
        return None
    if not isinstance(raw, dict):
        raise RequestError("'logit_bias' must be an object")
    parsed: dict[int, float] = {}
    for key, val in raw.items():
        try:
            token_id = int(key)
        except (TypeError, ValueError):
            raise RequestError(
                f"'logit_bias' key {key!r} is not a token id") from None
        if token_id < 0:
            # Negative ids would wrap via numpy indexing and bias the
            # WRONG token — the silent-wrong-output class this module
            # exists to prevent.
            raise RequestError(
                f"'logit_bias' key {token_id} is not a valid token id")
        try:
            bias = float(val)
        except (TypeError, ValueError):
            raise RequestError(
                f"'logit_bias' value for {key!r} is not a number") from None
        if not (-100.0 <= bias <= 100.0):
            raise RequestError(
                f"'logit_bias' value for token {token_id} must be in "
                f"[-100, 100], got {bias}")
        parsed[token_id] = bias
    return parsed or None


def validate_request(body: dict, kind: str) -> None:
    """Raise RequestError (-> HTTP 400) for unsupported or out-of-range
    fields. kind: "chat" | "completions"."""
    if not isinstance(body, dict):
        raise RequestError("request body must be a JSON object")
    allowed = CHAT_FIELDS if kind == "chat" else COMPLETION_FIELDS
    _reject_unknown(body, allowed)

    _check_range(body, "temperature", 0.0, 2.0)
    _check_range(body, "top_p", 0.0, 1.0)
    _check_range(body, "frequency_penalty", -2.0, 2.0)
    _check_range(body, "presence_penalty", -2.0, 2.0)
    _check_range(body, "repetition_penalty", 0.01, 10.0)
    _check_range(body, "min_p", 0.0, 1.0)
    mt = body.get("min_tokens")
    if mt is not None:
        if not isinstance(mt, int) or mt < 0:
            raise RequestError("'min_tokens' must be a non-negative "
                               "integer")

    n = body.get("n")
    if n is not None and n != 1:
        raise RequestError("only n=1 is supported")

    top_k = body.get("top_k")
    if top_k is not None:
        try:
            top_k_int = int(top_k)
        except (TypeError, ValueError):
            raise RequestError("'top_k' must be an integer") from None
        if top_k_int < 0:
            raise RequestError("'top_k' must be >= 0")

    stop = body.get("stop")
    if stop is not None and not isinstance(stop, str):
        if not (isinstance(stop, list)
                and all(isinstance(s, str) for s in stop)):
            raise RequestError(
                "'stop' must be a string or an array of strings")

    validate_logit_bias(body.get("logit_bias"))

    rf = body.get("response_format")
    if rf is not None:
        # json_object / json_schema are enforced by the engine-side
        # guided-decoding processor (llm/guided.py); anything else would
        # be silent wrong behavior.
        if not (isinstance(rf, dict)
                and rf.get("type") in ("text", "json_object",
                                       "json_schema")):
            got = rf.get("type") if isinstance(rf, dict) else rf
            raise RequestError(
                f"response_format type {got!r} is not supported "
                "(text, json_object, or json_schema)")
        if isinstance(rf, dict) and rf.get("type") == "json_schema":
            js = rf.get("json_schema")
            if not isinstance(js, dict) or not isinstance(
                    js.get("schema"), dict):
                raise RequestError(
                    "response_format json_schema needs "
                    "{'json_schema': {'schema': {...}}}")

    tc = body.get("tool_choice")
    if tc is not None:
        tools = body.get("tools")
        names = []
        if isinstance(tools, list):
            names = [n for n in ((t.get("function") or {}).get("name")
                                 for t in tools if isinstance(t, dict))
                     if isinstance(n, str) and n]
        if isinstance(tc, str):
            if tc not in ("none", "auto", "required"):
                raise RequestError(
                    "tool_choice must be 'none', 'auto', 'required', or "
                    "{'type': 'function', 'function': {'name': ...}}")
            if tc == "required" and not names:
                raise RequestError(
                    "tool_choice 'required' needs non-empty 'tools'")
        elif isinstance(tc, dict) and tc.get("type") == "function":
            name = (tc.get("function") or {}).get("name")
            if not isinstance(name, str) or not name:
                raise RequestError(
                    "tool_choice function needs a 'name'")
            if name not in names:
                raise RequestError(
                    f"tool_choice function {name!r} is not in 'tools'")
        else:
            raise RequestError(
                "tool_choice must be 'none', 'auto', 'required', or "
                "{'type': 'function', 'function': {'name': ...}}")
        if tc not in ("none", "auto") and isinstance(rf, dict) \
                and rf.get("type") in ("json_object", "json_schema"):
            raise RequestError(
                "tool_choice forcing and response_format "
                "json_object/json_schema cannot be combined")

    gd = (body.get("nvext") or {}).get("guided_decoding") \
        if isinstance(body.get("nvext"), dict) else None
    if gd is not None:
        if not isinstance(gd, dict):
            raise RequestError("nvext.guided_decoding must be an object")
        if isinstance(rf, dict) and rf.get("type") in ("json_object",
                                                       "json_schema"):
            raise RequestError(
                "nvext.guided_decoding and response_format "
                "json_object/json_schema cannot be combined (two "
                "constraints would intersect)")
        if tc is not None and tc not in ("none", "auto"):
            raise RequestError(
                "nvext.guided_decoding and tool_choice forcing cannot "
                "be combined (two constraints would intersect)")
        set_keys = [k for k in ("json", "regex", "choice", "grammar")
                    if gd.get(k) is not None]
        if len(set_keys) != 1:
            raise RequestError(
                "nvext.guided_decoding needs exactly one of json / "
                "regex / choice")
        if set_keys == ["json"] and not (
                isinstance(gd["json"], dict) or gd["json"] is True
                or gd["json"] == "object"):
            raise RequestError(
                "guided_decoding.json must be a JSON-schema object, "
                "true, or 'object'")
        if set_keys == ["grammar"]:
            raise RequestError(
                "guided_decoding.grammar (EBNF) is not supported; use "
                "json, regex, or choice")
        if set_keys == ["choice"] and not (
                isinstance(gd["choice"], list) and gd["choice"]
                and all(isinstance(c, str) for c in gd["choice"])):
            raise RequestError(
                "guided_decoding.choice must be a non-empty string list")
        if set_keys == ["regex"] and not isinstance(gd["regex"], str):
            raise RequestError("guided_decoding.regex must be a string")

    suffix = body.get("suffix")
    if suffix is not None and suffix != "":
        raise RequestError("'suffix' is not supported")

    if body.get("echo"):
        raise RequestError("'echo' is not supported")

    nvext = body.get("nvext")
    if nvext is not None:
        if not isinstance(nvext, dict):
            raise RequestError("'nvext' must be an object")
        unknown = sorted(k for k in nvext if k not in NVEXT_FIELDS)
        if unknown:
            raise RequestError(
                "Unsupported nvext parameter: "
                + ", ".join(f"'{k}'" for k in unknown))
        procs = nvext.get("logits_processors")
        if procs is not None:
            if not isinstance(procs, list):
                raise RequestError("'nvext.logits_processors' must be a list")
            for spec in procs:
                if not (isinstance(spec, str)
                        or (isinstance(spec, dict) and "name" in spec)):
                    raise RequestError(
                        "each logits processor must be a name or an "
                        "object with a 'name'")
