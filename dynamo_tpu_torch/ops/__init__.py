"""The port's kernels and the attention functions built on them.

`ops.paged_attention` names the module; its unified-forward
`attention_fn` of the same name is imported from there
(`from dynamo_tpu_torch.ops.paged_attention import paged_attention`).
"""

from .paged_attention import (
    paged_attention_decode_fused,
    paged_attention_decode_pool,
    paged_attention_spec,
    paged_attention_spec_pool,
    paged_decode_attention,
    paged_decode_attention_partial,
    paged_decode_attention_pool,
    paged_decode_attention_pool_folded,
    paged_decode_attention_pool_int8,
    paged_decode_attention_pool_int8_folded,
    paged_decode_attention_pool_ref,
)
from .q4_linear import (
    Q4Weight,
    q4_matmul,
    q4_matmul_ref,
    q4_matmul_v1,
    q4_matmul_v2,
)
from .q8_linear import Q8Weight, q8_matmul, q8_matmul_ref

__all__ = [
    "paged_attention_decode_fused",
    "paged_attention_decode_pool", "paged_attention_spec",
    "paged_attention_spec_pool", "paged_decode_attention",
    "paged_decode_attention_partial", "paged_decode_attention_pool",
    "paged_decode_attention_pool_folded", "paged_decode_attention_pool_int8",
    "paged_decode_attention_pool_int8_folded",
    "paged_decode_attention_pool_ref",
    "Q4Weight", "q4_matmul", "q4_matmul_ref", "q4_matmul_v1", "q4_matmul_v2",
    "Q8Weight", "q8_matmul", "q8_matmul_ref", "kernel_wrappers",
    "counted_wrappers",
]


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by kernel name. Each counts, in
    `.launches`, the calls that launched its kernel (never its plain
    version)."""
    return {
        "paged_decode_attention_pool": paged_decode_attention_pool,
        "paged_decode_attention_pool_int8": paged_decode_attention_pool_int8,
        "paged_decode_attention_pool_folded":
            paged_decode_attention_pool_folded,
        "paged_decode_attention_pool_int8_folded":
            paged_decode_attention_pool_int8_folded,
        "paged_decode_attention": paged_decode_attention,
        "paged_decode_attention_partial": paged_decode_attention_partial,
        "q8_matmul": q8_matmul,
        "q4_matmul_v2": q4_matmul_v2,
        "q4_matmul_v1": q4_matmul_v1,
    }


def counted_wrappers() -> dict:
    """`kernel_wrappers()` and the fused passes that port no TPU kernel
    (the sampler's noise): every wrapper whose `.launches` a CUDA-graph
    replay re-adds."""
    from .gumbel import gumbel_noise

    return {**kernel_wrappers(), "gumbel_noise": gumbel_noise}
