"""ModelDeploymentCard: everything a frontend needs to serve a model.

Port of `dynamo_tpu/llm/model_card.py`, the same record on the wire (ref:
lib/llm/src/model_card.rs:183; written to
v1/mdc/{ns}/{component}/{endpoint}/{instance_id}). Workers publish it when
they register; a frontend's ModelWatcher builds a serving pipeline from it.
`runtime_config["kv_hash_version"]` is the block-hash scheme's version, the
reference's HASH_VERSION, since this package's block hashes are the
reference's (tokens.py). Tool and reasoning parsers are not ported yet: a
card that names one is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..runtime.discovery import MODEL_CARD_PREFIX

# Model types (ref: ModelType Chat|Completions|Prefill|Embeddings...)
CHAT = "chat"
COMPLETIONS = "completions"

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
    tool_parser: Optional[str] = None
    reasoning_parser: Optional[str] = None
    # Serving component this card belongs to
    namespace: str = "dynamo"
    component: str = "backend"
    endpoint: str = "generate"
    # Router hints
    total_kv_blocks: int = 0
    data_parallel_size: int = 1
    runtime_config: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        for kind, name in (("tool", self.tool_parser),
                           ("reasoning", self.reasoning_parser)):
            if name:
                raise ValueError(
                    f"{kind} parser {name!r}: output parsers are not ported "
                    "yet")
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
