"""python -m dynamo_tpu_torch.frontend: the OpenAI frontend."""
import asyncio
import logging

from .service import main

logging.basicConfig(level=logging.INFO)
asyncio.run(main())
