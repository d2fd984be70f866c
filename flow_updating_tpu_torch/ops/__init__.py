"""Tensor operations of the port (counterpart of
``flow_updating_tpu/ops``): the neighbor sums and networks of the node
and edge rounds, the wrappers of the hand-written CUDA kernels, and the
structured stencils, which the package index exports as the JAX
package's does."""

from flow_updating_tpu_torch.ops.structured import (
    CompleteStruct,
    FatTreeStruct,
    Grid2dStruct,
    HypercubeStruct,
    RingStruct,
    Torus2dStruct,
    structured_neighbor_sum,
)

__all__ = [
    "CompleteStruct",
    "FatTreeStruct",
    "Grid2dStruct",
    "HypercubeStruct",
    "RingStruct",
    "Torus2dStruct",
    "structured_neighbor_sum",
]
