"""CLI alias package: python -m dynamo_tpu_torch.worker runs the engine
worker (engine/worker.py)."""
