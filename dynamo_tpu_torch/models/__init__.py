from .config import PRESETS, ModelConfig, get_config
from .convert import params_from_numpy
from .transformer import (
    Transformer,
    forward,
    forward_decode,
    init_params,
    make_kv_cache,
)

__all__ = [
    "PRESETS", "ModelConfig", "get_config", "params_from_numpy",
    "Transformer", "forward", "forward_decode", "init_params",
    "make_kv_cache",
]
