from .model_runner import ModelRunner, RunnerConfig, bucket_table_width
from .pages import PageAllocation, PagePool
from .scheduler import InferenceScheduler
from .worker import TorchWorker

__all__ = [
    "ModelRunner", "RunnerConfig", "bucket_table_width", "PageAllocation",
    "PagePool", "InferenceScheduler", "TorchWorker",
]
