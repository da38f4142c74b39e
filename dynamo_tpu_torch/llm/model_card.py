"""ModelDeploymentCard: everything a frontend needs to serve a model.

Port of `dynamo_tpu/llm/model_card.py`, the same record on the wire (ref:
lib/llm/src/model_card.rs:183; written to
v1/mdc/{ns}/{component}/{endpoint}/{instance_id}). Workers publish it when
they register; a frontend's ModelWatcher builds a serving pipeline from it.
`runtime_config["kv_hash_version"]` is the block-hash scheme's version, the
reference's HASH_VERSION, since this package's block hashes are the
reference's (tokens.py). A card names its tool and reasoning parsers
(`parsers/`), checked against the parsers this package has.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..parsers import REASONING_PARSERS, TOOL_PARSERS
from ..runtime.discovery import MODEL_CARD_PREFIX

# Model types (ref: ModelType Chat|Completions|Prefill|Embeddings...)
CHAT = "chat"
COMPLETIONS = "completions"
PREFILL = "prefill"  # a disaggregated prefill worker's card

# Model input type (ref: ModelInput::Tokens)
INPUT_TOKENS = "tokens"

# Version of the chained block-hash scheme (the reference's HASH_VERSION).
HASH_VERSION = 2


@dataclasses.dataclass
class ModelDeploymentCard:
    name: str
    model_types: list[str] = dataclasses.field(
        default_factory=lambda: [CHAT, COMPLETIONS])
    model_input: str = INPUT_TOKENS
    tokenizer: dict = dataclasses.field(
        default_factory=lambda: {"kind": "byte"})
    context_length: int = 8192
    max_output_tokens: int = 4096
    kv_block_size: int = 16
    chat_template: Optional[str] = None
    # Output parsing (ref: lib/parsers wiring via model card runtime config)
    tool_parser: Optional[str] = None  # hermes|mistral|llama3_json|pythonic
    reasoning_parser: Optional[str] = None  # think|deepseek-r1|granite
    # Serving component this card belongs to
    namespace: str = "dynamo"
    component: str = "backend"
    endpoint: str = "generate"
    # Router hints
    total_kv_blocks: int = 0
    data_parallel_size: int = 1
    runtime_config: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        # Fail at card construction (worker startup / card publish), not per
        # request inside the frontend's delta generator.
        if self.tool_parser and self.tool_parser.lower() not in TOOL_PARSERS:
            raise ValueError(
                f"unknown tool parser {self.tool_parser!r}; "
                f"one of {sorted(TOOL_PARSERS)}")
        if (self.reasoning_parser
                and self.reasoning_parser.lower() not in REASONING_PARSERS):
            raise ValueError(
                f"unknown reasoning parser {self.reasoning_parser!r}; "
                f"one of {sorted(REASONING_PARSERS)}")
        # KV identities only match between processes on the same hash scheme.
        self.runtime_config.setdefault("kv_hash_version", HASH_VERSION)

    def card_key(self, instance_id: int) -> str:
        return (f"{MODEL_CARD_PREFIX}/{self.namespace}/{self.component}/"
                f"{self.endpoint}/{instance_id}")

    @property
    def endpoint_subject(self) -> str:
        return f"{self.namespace}/{self.component}/{self.endpoint}"

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, data: dict) -> "ModelDeploymentCard":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})


async def publish_card(runtime, card: ModelDeploymentCard,
                       instance_id: int) -> None:
    """Attach a model card under the runtime lease (ref: LocalModel.attach)."""
    await runtime.put_leased(card.card_key(instance_id), card.to_wire())


async def unpublish_card(runtime, card: ModelDeploymentCard,
                         instance_id: int) -> None:
    await runtime.delete_leased(card.card_key(instance_id))
