"""RSU serving tier — counterpart of `repro.serve`.

The learner (``run(scenario, publish=store.publish)``) publishes each new
global model into a `ModelStore` of immutable snapshots; `RSUServer`
answers vehicle fetches from them with request batching and admission
control, so vehicles pull models without blocking a training round.
"""
from repro_torch.serve.server import (PendingFetch, Reply, RSUServer,
                                      ServePolicy, apply_reply, build_reply)
from repro_torch.serve.store import ModelStore, Snapshot

__all__ = [
    "ModelStore",
    "PendingFetch",
    "Reply",
    "RSUServer",
    "ServePolicy",
    "Snapshot",
    "apply_reply",
    "build_reply",
]
