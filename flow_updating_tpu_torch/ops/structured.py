"""Closed-form neighbor sums for regular topologies: no gather at all.

Counterpart of ``flow_updating_tpu/ops/structured.py``.  The node-collapsed
round (``models/sync.py``) needs one graph operation, the neighbor sum
``A(x)[u] = sum of x[v] over u's neighbors``.  On the regular graphs the
generators build (ring, grid, torus, hypercube, complete graph, fat tree)
the adjacency is index arithmetic, so ``A`` is a stencil of reshapes,
rolls, flips, broadcasts and small-axis sums, with no index table and no
routing plan (``spmv='structured'``).

Each descriptor is a frozen, hashable dataclass that the generator which
built the graph attaches to
:attr:`~flow_updating_tpu_torch.topology.graph.Topology.structure`.
``neighbor_sum`` takes and returns the ``(n,)`` tensor in the generator's
node order.  Where the addition order shows in the bits it is the JAX
package's: the ring adds ``roll(x, d)`` then ``roll(x, -d)`` for ``d = 1
.. k``; the grid the row shifts, then the column shifts; the hypercube
flips the most significant bit first; the fat tree sums as
:meth:`FatTreeStruct.pod_local_sums` says.  This is plain tensor code, as
in the JAX package, which reaches no ``pallas_call`` here.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RingStruct:
    """Ring lattice: i ~ i±1..±k (mod n).  ``A(x) = sum_d roll(x, d) +
    roll(x, -d)``.

    Valid only when ``n > 2k`` (below that the generator's edges collapse
    under symmetrization and the roll form would count some twice); the
    generator attaches it only then."""

    n: int
    k: int

    def neighbor_sum(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros_like(x)
        for d in range(1, self.k + 1):
            acc = acc + torch.roll(x, d) + torch.roll(x, -d)
        return acc


@dataclasses.dataclass(frozen=True)
class Grid2dStruct:
    """2-D grid, 4-neighborhood, not periodic: shifted adds."""

    h: int
    w: int

    @property
    def n(self) -> int:
        return self.h * self.w

    def neighbor_sum(self, x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(self.h, self.w)
        acc = torch.zeros_like(g)
        if self.h > 1:
            acc[1:] += g[:-1]
            acc[:-1] += g[1:]
        if self.w > 1:
            acc[:, 1:] += g[:, :-1]
            acc[:, :-1] += g[:, 1:]
        return acc.reshape(-1)


@dataclasses.dataclass(frozen=True)
class CompleteStruct:
    """Complete graph: ``A(x) = sum(x) - x``."""

    n: int

    def neighbor_sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x) - x


@dataclasses.dataclass(frozen=True)
class Torus2dStruct:
    """2-D torus (periodic 4-neighborhood): four rolls.  Needs ``h, w >=
    3`` (below that the wrap edges collapse under symmetrization)."""

    h: int
    w: int

    @property
    def n(self) -> int:
        return self.h * self.w

    def neighbor_sum(self, x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(self.h, self.w)
        acc = (torch.roll(g, 1, 0) + torch.roll(g, -1, 0)
               + torch.roll(g, 1, 1) + torch.roll(g, -1, 1))
        return acc.reshape(-1)


@dataclasses.dataclass(frozen=True)
class HypercubeStruct:
    """d-dimensional hypercube: node i's neighbors are ``i ^ (1 << b)``.

    The JAX package flips one axis of the ``(2,)*d`` view per bit, axis 0
    (the most significant bit) first.  A tensor of more than 25 dimensions
    is not safe in PyTorch's elementwise machinery, so bit ``b`` flips the
    middle axis of a ``(2^(d-1-b), 2, 2^b)`` view instead, in the same bit
    order: the same values."""

    d: int

    @property
    def n(self) -> int:
        return 1 << self.d

    def neighbor_sum(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros_like(x)
        for b in range(self.d - 1, -1, -1):
            g = x.reshape(1 << (self.d - 1 - b), 2, 1 << b)
            acc = acc + torch.flip(g, (1,)).reshape(-1)
        return acc


@dataclasses.dataclass(frozen=True)
class FatTreeStruct:
    """Al-Fares k-ary fat tree in the generator's node layout
    (``topology/generators.py:fat_tree``): hosts ``(k, k/2, k/2)``, edge
    switches ``(k, k/2)``, aggregation switches ``(k, k/2)``, core
    switches ``(k/2, k/2)``, concatenated in that order.

    * host (p, e, i) ~ edge (p, e)                 -> broadcast
    * edge (p, e)    ~ hosts (p, e, .) + aggs (p, .) -> two row sums
    * agg  (p, a)    ~ edges (p, .) + cores (a, .)   -> two row sums
    * core (a, c)    ~ aggs (., a)                   -> one column sum
    """

    k: int

    @property
    def half(self) -> int:
        return self.k // 2

    @property
    def n(self) -> int:
        return self.half * self.half * self.k + self.half * self.k * 2 \
            + self.half * self.half

    def sections(self, x):
        """The four class sections of a node vector (a tensor or a numpy
        array): host ``(k, k/2, k/2)``, edge ``(k, k/2)``, agg ``(k,
        k/2)``, core ``(k/2, k/2)`` — views, in the generator's layout."""
        k, half = self.k, self.half
        n_host = half * half * k
        n_sw = half * k
        return (
            x[:n_host].reshape(k, half, half),
            x[n_host:n_host + n_sw].reshape(k, half),
            x[n_host + n_sw:n_host + 2 * n_sw].reshape(k, half),
            x[n_host + 2 * n_sw:].reshape(half, half),
        )

    @staticmethod
    def pod_local_sums(xh, xe, xa, xc):
        """The stencil terms of any contiguous block of pods (``xc`` is the
        whole core grid).  Returns ``(a_host, a_edge, a_agg,
        a_core_partial)`` with ``a_core_partial[a]`` the sum over the
        block's pods of ``xa[p, a]``: the partials of all blocks add up to
        the core column sum (``parallel/structured_sharded.py``)."""
        kb, h = xe.shape
        a_host = xe[:, :, None].expand(kb, h, h)
        a_edge = xh.sum(2) + xa.sum(1, keepdim=True)
        a_agg = xe.sum(1, keepdim=True) + xc.sum(1)[None, :]
        return a_host, a_edge, a_agg, xa.sum(0)

    def neighbor_sum(self, x: torch.Tensor) -> torch.Tensor:
        xh, xe, xa, xc = self.sections(x)
        a_host, a_edge, a_agg, part = self.pod_local_sums(xh, xe, xa, xc)
        a_core = part[:, None].expand(xc.shape)
        return torch.cat([a_host.reshape(-1), a_edge.reshape(-1),
                          a_agg.reshape(-1), a_core.reshape(-1)])


def structured_neighbor_sum(x: torch.Tensor, struct) -> torch.Tensor:
    """``struct``'s neighbor sum of the first ``struct.n`` entries of a
    (possibly padded) vector; the padding slots get 0, as the gather
    routes give their zero slot."""
    n = struct.n
    a = struct.neighbor_sum(x[:n])
    if x.shape[0] == n:
        return a
    return torch.cat([a, x.new_zeros(x.shape[0] - n)])
