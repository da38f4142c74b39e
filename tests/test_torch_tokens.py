"""The port's pure-Python block hashing (dynamo_tpu_torch.tokens) is
bit-identical to the JAX package's (dynamo_tpu.tokens: xxhash wheel or the
C++ extension), so prefix-cache identities agree across the packages."""

import numpy as np
import pytest
import xxhash

from dynamo_tpu import tokens as j_tokens
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu_torch import tokens
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 31, 32, 33, 63, 64, 100, 1000])
@pytest.mark.parametrize("seed", [0, 1, 0xD3A10C0DE, 2**64 - 1])
def test_xxh64_matches_reference(n, seed):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tokens.xxh64(data, seed) == xxhash.xxh64_intdigest(data, seed=seed)


@pytest.mark.parametrize("block_size", [1, 4, 16, 64])
@pytest.mark.parametrize("lora", [None, "adapter-a"])
def test_block_hashes_bit_identical(block_size, lora):
    toks = np.random.default_rng(block_size).integers(
        0, 2**31, 1000).tolist()
    lora_id = j_tokens.lora_id_of(lora)
    assert tokens.lora_id_of(lora) == lora_id
    assert tokens.compute_block_hashes(toks, block_size, lora_id=lora_id) == \
        j_tokens.compute_block_hashes(toks, block_size, lora_id=lora_id)


def test_token_block_sequence_increments():
    toks = np.random.default_rng(3).integers(0, 128256, 203).tolist()
    lora_id = j_tokens.lora_id_of("x")
    mine = tokens.TokenBlockSequence(16, lora_id=lora_id)
    ref = j_tokens.TokenBlockSequence(16, lora_id=lora_id)
    for lo, hi in [(0, 5), (5, 16), (16, 17), (17, 80), (80, 203)]:
        assert mine.extend(toks[lo:hi]) == ref.extend(toks[lo:hi])
    assert mine.block_hashes == ref.block_hashes
    assert mine.tokens == ref.tokens


def test_kv_salt_matches():
    """LoRA name and chained media hashes salt the hashes identically."""
    kw = dict(request_id="r", token_ids=[1, 2, 3], lora_name="ad",
              media_hashes=[5, 2**63 + 7, 11])
    mine = PreprocessedRequest(sampling=SamplingOptions(),
                               stop=StopConditions(), **kw)
    ref = JRequest(sampling=JSampling(), stop=JStop(), **kw)
    assert mine.kv_salt() == ref.kv_salt()
