"""The port's streaming tool-call and reasoning parsers (`parsers/`) against
the JAX package's, on the same text split at every boundary.

For each tool parser and each reasoning parser, and each text of the
reference's own parser tests (plus plain text and malformed blocks), the
text is pushed in two pieces at every split point and in chunks of 1, 2, 3
and 7 characters, then finalized: the port's events equal the reference's
event for event (content, reasoning, and each call's name and arguments; a
call's id is random in both). Also the registries, their refusals, and the
chat DeltaGenerator routing a stream through both parsers into
`reasoning_content` / `tool_calls` deltas and a `tool_calls` finish, as the
reference's does.
"""

import pytest

from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
from dynamo_tpu.llm.preprocessor import DeltaGenerator as RefDeltaGenerator
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as RefPre
from dynamo_tpu.llm.protocols import EngineOutput as RefOutput
from dynamo_tpu.llm.protocols import PreprocessedRequest as RefRequest
from dynamo_tpu.llm.protocols import SamplingOptions as RefSampling
from dynamo_tpu.llm.protocols import StopConditions as RefStop
from dynamo_tpu import parsers as ref_parsers
from dynamo_tpu_torch import parsers
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import DeltaGenerator, OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols import (
    EngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

HERMES = ('<tool_call>{"name": "get_weather", "arguments": {"city": "SF"}}'
          '</tool_call>')
TOOL_TEXTS = {
    "hermes": [f"Let me check. {HERMES} done", HERMES + HERMES,
               "<tool_call>not json</tool_call>", "plain <tool_ answer"],
    "mistral": ['thinking [TOOL_CALLS] [{"name": "a", "arguments": {"x": 1}},'
                ' {"name": "b", "arguments": {}}]', "[TOOL_CALLS] [broken"],
    "llama3_json": ['{"name": "lookup", "parameters": {"q": "tpu"}}',
                    "just a normal answer", '{"not": "a call"}'],
    "pythonic": ['[get_weather(city="SF"), sum_all(1, 2)]',
                 "[1, 2, 3] is a list"],
    "xml": ["let me check. <tool_call>\n<function=get_weather>\n"
            "<parameter=city>\nParis\n</parameter>\n"
            "<parameter=days>\n3\n</parameter>\n"
            "</function>\n</tool_call> done.",
            "<tool_call>not a function block</tool_call>"],
    "dsml": ["ok <｜tool▁calls▁begin｜><｜tool▁call▁begin｜>function"
             "<｜tool▁sep｜>lookup\n```json\n{\"q\": \"x\"}\n```"
             "<｜tool▁call▁end｜><｜tool▁calls▁end｜>",
             "<｜tool▁calls▁begin｜>"
             "<｜tool▁call▁begin｜>function<｜tool▁sep｜>good\n"
             "```json\n{\"a\": 1}\n```<｜tool▁call▁end｜>"
             "<｜tool▁call▁begin｜>function<｜tool▁sep｜>broken\n"
             "```json\n{\"b\": trunc"],
    "harmony": ["<|channel|>analysis<|message|>thinking...<|end|>"
                "<|channel|>commentary to=functions.get_time "
                "<|constrain|>json<|message|>{\"tz\": \"UTC\"}<|call|>"
                "<|channel|>final<|message|>It is noon.<|return|>",
                "just plain text",
                "<|channel|>final<|message|>cut off mid"],
}
TOOL_TEXTS["qwen"] = TOOL_TEXTS["hermes"][:2]
REASONING_TEXTS = {
    "think": ["<think>step one</think>the answer",
              "pre<think>mid</think>post", "<think>ran out of budget",
              "no tags at all"],
    "deepseek-r1": ["implicit thought</think>visible", "only thought"],
    "granite": ["Here is my thought process: hmm Here is my response: ok",
                "Here is my thought"],
    "harmony": ["<|channel|>analysis<|message|>deep thought<|end|>"
                "<|channel|>final<|message|>answer",
                "<|channel|>analysis<|message|>first<|end|>"
                "<|channel|>commentary to=functions.f <|message|>{}<|call|>"
                "<|channel|>analysis<|message|>second<|end|>"
                "<|channel|>final<|message|>done<|return|>"],
    "gpt-oss": ["<|channel|>analysis<|message|>a<|end|>text"],
}


def _events(parser, pieces) -> list:
    """Push `pieces`, then finalize: each event as a comparable tuple."""
    out = []
    for ev in [parser.push(p) for p in pieces] + [parser.finalize()]:
        if hasattr(ev, "calls"):
            out.append((ev.content, [(c.name, c.arguments)
                                     for c in ev.calls]))
        else:
            out.append((ev.reasoning, ev.content))
    return out


def _splits(text):
    for i in range(len(text) + 1):
        yield [text[:i], text[i:]]
    for n in (1, 2, 3, 7):
        yield [text[j:j + n] for j in range(0, len(text), n)]


def test_registries_match():
    assert sorted(parsers.TOOL_PARSERS) == sorted(ref_parsers.TOOL_PARSERS)
    assert (sorted(parsers.REASONING_PARSERS)
            == sorted(ref_parsers.REASONING_PARSERS))
    for make, ref_make in ((parsers.make_tool_parser,
                            ref_parsers.make_tool_parser),
                           (parsers.make_reasoning_parser,
                            ref_parsers.make_reasoning_parser)):
        with pytest.raises(ValueError) as mine:
            make("bogus")
        with pytest.raises(ValueError) as theirs:
            ref_make("bogus")
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("name", sorted(TOOL_TEXTS))
def test_tool_parser_events_equal_the_reference(name):
    calls = 0
    for text in TOOL_TEXTS[name]:
        for pieces in _splits(text):
            mine = _events(parsers.make_tool_parser(name), pieces)
            assert mine == _events(ref_parsers.make_tool_parser(name),
                                   pieces), (text, pieces)
            calls += sum(len(c) for _, c in mine)
    assert calls > 0


@pytest.mark.parametrize("name", sorted(REASONING_TEXTS))
def test_reasoning_parser_events_equal_the_reference(name):
    for text in REASONING_TEXTS[name]:
        for pieces in _splits(text):
            assert (_events(parsers.make_reasoning_parser(name), pieces)
                    == _events(ref_parsers.make_reasoning_parser(name),
                               pieces)), (text, pieces)


def _chunks(gen_cls, pre_cls, card_cls, req, sampling, stop, output, text,
            **parsers_kw):
    pre = pre_cls(card_cls(name="m", tokenizer={"kind": "byte"}))
    gen = gen_cls(pre, req(request_id="r", token_ids=[1, 2],
                           sampling=sampling(), stop=stop(), model="m"),
                  kind="chat", **parsers_kw)
    tokens = pre.tokenizer.encode(text)
    chunks = []
    for i, t in enumerate(tokens):
        chunks += gen.on_output(output(
            token_ids=[t],
            finish_reason="stop" if i == len(tokens) - 1 else None))
    final = gen.final_response()
    for c in chunks + [final]:  # ids and timestamps differ run to run
        c.pop("id"), c.pop("created")
    for c in chunks:
        for call in c["choices"][0]["delta"].get("tool_calls", []):
            call.pop("id")
    for call in final["choices"][0]["message"].get("tool_calls", []):
        call.pop("id")
    return chunks, final


@pytest.mark.parametrize("kw,text", [
    ({"tool_parser": "hermes", "reasoning_parser": "think"},
     '<think>need weather</think>'
     '<tool_call>{"name": "w", "arguments": {}}</tool_call>'),
    ({"tool_parser": "hermes"}, f"Sure. {HERMES}"),
    ({"reasoning_parser": "deepseek-r1"}, "hmm</think>the answer"),
    ({}, "hello world"),
], ids=["both", "tools", "reasoning", "none"])
def test_delta_generator_routes_as_the_reference(kw, text):
    mine = _chunks(DeltaGenerator, OpenAIPreprocessor, ModelDeploymentCard,
                   PreprocessedRequest, SamplingOptions, StopConditions,
                   EngineOutput, text, **kw)
    theirs = _chunks(RefDeltaGenerator, RefPre, RefCard, RefRequest,
                     RefSampling, RefStop, RefOutput, text, **kw)
    assert mine == theirs
    if "tool_parser" in kw:
        assert mine[1]["choices"][0]["finish_reason"] == "tool_calls"
        assert mine[1]["choices"][0]["message"]["tool_calls"]


@pytest.mark.parametrize("field,name", [("tool_parser", "hermes"),
                                        ("tool_parser", "xml"),
                                        ("reasoning_parser", "think"),
                                        ("reasoning_parser", "bogus")])
def test_cards_carry_parsers_as_the_reference_does(field, name):
    """A card naming a parser is served; an unknown name is refused at card
    construction with the reference's message."""
    if name == "bogus":
        with pytest.raises(ValueError) as mine:
            ModelDeploymentCard(name="m", **{field: name})
        with pytest.raises(ValueError) as theirs:
            RefCard(name="m", **{field: name})
        assert str(mine.value) == str(theirs.value)
        return
    card = ModelDeploymentCard(name="m", **{field: name})
    ref = RefCard(name="m", **{field: name})
    assert card.to_wire() == ref.to_wire()
    assert ModelDeploymentCard.from_wire(ref.to_wire()) == card
