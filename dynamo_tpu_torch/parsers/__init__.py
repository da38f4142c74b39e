"""Streaming tool-call + reasoning output parsers (ref: lib/parsers).

Copy of `dynamo_tpu/parsers/` (the standard library only): the same
events on the same text, pinned by tests/test_torch_parsers.py.
"""

from .reasoning import (
    REASONING_PARSERS,
    ReasoningEvent,
    StreamingReasoningParser,
    make_reasoning_parser,
)
from .tool_calls import (
    TOOL_PARSERS,
    HermesToolParser,
    Llama3JsonToolParser,
    MistralToolParser,
    PythonicToolParser,
    ToolCall,
    ToolEvent,
    make_tool_parser,
)

__all__ = [
    "HermesToolParser", "Llama3JsonToolParser", "MistralToolParser",
    "PythonicToolParser", "REASONING_PARSERS", "ReasoningEvent",
    "StreamingReasoningParser", "TOOL_PARSERS", "ToolCall", "ToolEvent",
    "make_reasoning_parser", "make_tool_parser",
]
