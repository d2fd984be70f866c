"""Multi-tenant query fabric: thousands of concurrent cohort aggregates on
one set of service tensors (counterpart of ``flow_updating_tpu/query``).

The ``(N, D)`` payload axis is a lane machine — each lane an independent
scalar protocol instance sharing one set of messages; the fabric makes it
a query axis on top of the streaming service engine: queries admit into
free lanes and converged lanes retire and recycle between segments, with
one dispatch signature throughout.  See :mod:`.fabric`.
"""

from flow_updating_tpu_torch.query.fabric import QueryFabric

__all__ = ["QueryFabric"]
