"""python -m dynamo_tpu_torch.worker: the engine worker."""
import asyncio
import logging

from ..engine.worker import main

logging.basicConfig(level=logging.INFO)
asyncio.run(main())
