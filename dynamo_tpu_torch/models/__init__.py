from .config import PRESETS, ModelConfig, get_config
from .convert import kv_cache_from_numpy, params_from_numpy
from .transformer import (
    Transformer,
    forward,
    forward_decode,
    forward_embed,
    forward_spec,
    init_params,
    make_kv_cache,
    make_kv_cache_int8,
    quantize_kv,
)

__all__ = [
    "PRESETS", "ModelConfig", "get_config", "kv_cache_from_numpy",
    "params_from_numpy", "Transformer", "forward", "forward_decode", "forward_embed",
    "forward_spec",
    "init_params", "make_kv_cache", "make_kv_cache_int8", "quantize_kv",
]
