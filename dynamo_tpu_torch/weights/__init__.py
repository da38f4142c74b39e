"""Weight service: an out-of-process host-memory weight store, and weight
streaming between workers.

Port of `dynamo_tpu/weights/` (the reference's GPU Memory Service and
ModelExpress analogs), carrying the port's `Transformer` with the JAX
package's leaf names, dtype names and bytes, so both packages share one
service, one object store and one wire:

  * `WeightServiceServer` (own process, `python -m dynamo_tpu_torch.weights`)
    owns POSIX shared-memory segments holding each model's parameters; a
    crashed or restarted worker re-attaches them and copies them to the card
    — no init, no checkpoint read;
  * `WeightClient.load_or_init` is the worker-side one-liner: attach if
    present, else init and publish for the next restart;
  * peer streaming (`weights/streaming.py`): a cold worker pulls parameters
    from a live replica over the request plane in chunked raw-bytes frames;
  * striped streaming (`weights/striped.py`): the same pull
    content-addressed and fanned out across N live replicas, with per-chunk
    digests, resume-after-donor-death and donor-side bandwidth budgeting;
  * the object-store rung (`weights/objstore.py`): the chunk tree published
    to and fetched from the G4 store when no live peer serves the model.
"""

from .client import WeightClient
from .service import WeightServiceServer, serve_in_process
from .striped import (
    BandwidthBudget,
    StripedAssembler,
    WeightManifest,
    pull_striped,
    pull_weights_striped,
)

__all__ = ["WeightClient", "WeightServiceServer", "serve_in_process",
           "WeightManifest", "StripedAssembler", "BandwidthBudget",
           "pull_striped", "pull_weights_striped"]
