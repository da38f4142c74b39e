"""Multi-tier KV block manager (KVBM): G1 device -> G2 host -> G3 disk ->
G4 object store.

Port of `dynamo_tpu/block_manager/`, without its multi-host half
(`distributed.py`). TinyLFU is the port's one copy, `kv_router/tinylfu.py`.
"""

from ..kv_router.tinylfu import TinyLfu
from .layout import BlockLayoutSpec, assemble, reslice
from .manager import KvBlockManager, KvbmConfig, KvbmStats
from .offload import OffloadManager
from .pool import TierPool
from .state import BlockHandle, BlockState, BlockStateError
from .storage import DiskArena, HostArena, ObjectStore

__all__ = [
    "BlockHandle", "BlockLayoutSpec", "BlockState", "BlockStateError",
    "DiskArena", "HostArena", "KvBlockManager", "KvbmConfig", "KvbmStats",
    "ObjectStore", "OffloadManager", "TierPool", "TinyLfu", "assemble",
    "reslice",
]
