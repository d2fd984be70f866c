"""Device mesh of the port: S shards of the node axis in one process.

Counterpart of ``flow_updating_tpu/parallel/mesh.py``.  The JAX mesh is a
``jax.sharding.Mesh`` over ``'nodes'`` whose shard bodies run under
``shard_map``.  Here a :class:`Mesh` is the ordered list of shard devices
plus, on the card, one ``torch.cuda.Stream`` per shard: each shard keeps
its own tensors, and its work runs on its own stream, so shards that share
a card still run side by side.

Shards are placed round-robin over the visible cards (shard ``s`` on
``cuda:{s % device_count}``), so all shards share one card when one is
visible — the counterpart of the virtual CPU mesh the JAX tests run on.
Everything stays in one process: NCCL refuses two ranks on one card, so a
process per shard could not run this mesh on a one-card machine.
Processes over ``torch.distributed`` belong to the multi-host item.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from flow_updating_tpu_torch.utils.device import resolve_device

NODE_AXIS = "nodes"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The shard devices of the node axis, in shard order.

    ``streams`` holds one CUDA stream per shard on the card (``None`` for
    a shard on the host)."""

    devices: tuple          # (S,) torch.device
    streams: tuple          # (S,) torch.cuda.Stream | None
    axis: str = NODE_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type


def make_mesh(n_shards: int, device=None) -> Mesh:
    """A mesh of ``n_shards`` shards of the node axis.

    ``device=None`` (or ``'cuda'``) places shard ``s`` on
    ``cuda:{s % torch.cuda.device_count()}`` and raises without a card;
    ``'cuda:k'`` puts every shard on card ``k``; ``'cpu'`` every shard on
    the host."""
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh(devices=(dev,) * n, streams=(None,) * n)
    if dev.index is None:
        cards = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", s % cards) for s in range(n))
    else:
        devices = (dev,) * n
    return Mesh(devices=devices,
                streams=tuple(torch.cuda.Stream(device=d) for d in devices))


def on_stream(stream):
    """The context that makes ``stream`` current (a shard's stream on the
    card); a host shard's ``None`` changes nothing."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def check_mesh(mesh, device=None) -> None:
    """Refuse what is no :class:`Mesh`, or a ``device`` that disagrees
    with the mesh's shards."""
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh= takes a flow_updating_tpu_torch.parallel."
                        f"mesh.Mesh (make_mesh), got {type(mesh).__name__}")
    if device is not None and torch.device(device).type \
            != mesh.device_type:
        raise ValueError(
            f"device={device!r} disagrees with the mesh, whose shards "
            f"are on {mesh.device_type}")
