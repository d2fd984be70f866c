"""The streaming service of the port (counterpart of
``flow_updating_tpu/service``).

* :mod:`.engine` — :class:`ServiceEngine`: one set of tensors at a fixed
  capacity, run in segments, with membership and edge events as indexed
  writes between them (join, leave, update, suspend, resume, add and
  remove edges), bounded-staleness reads, service checkpoints, and the
  WAL + checkpoint-ring durability of :mod:`flow_updating_tpu_torch.
  resilience`;
* :mod:`.membership` — the alive-mask primitive every churn surface
  shares (the engine's node faults too);
* :mod:`.aliasing` — the probe that no device leaf shares memory with
  a host mirror.

The query fabric (:mod:`flow_updating_tpu_torch.query`) and the aggregate
fabric (:mod:`flow_updating_tpu_torch.aggregates`) wrap a
``ServiceEngine``.
"""

from flow_updating_tpu_torch.service.engine import (
    SERVICE_EVENTS,
    ServiceEngine,
    validate_service_config,
)
from flow_updating_tpu_torch.service.membership import set_alive

__all__ = ["SERVICE_EVENTS", "ServiceEngine", "set_alive",
           "validate_service_config"]
