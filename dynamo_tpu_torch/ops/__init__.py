from .paged_attention import (
    paged_attention_decode_pool,
    paged_decode_attention_pool,
    paged_decode_attention_pool_ref,
)

__all__ = [
    "paged_attention_decode_pool", "paged_decode_attention_pool",
    "paged_decode_attention_pool_ref",
]
