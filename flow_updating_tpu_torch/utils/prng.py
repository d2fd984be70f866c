"""Threefry-2x32 random numbers, bit-compatible with ``jax.random``.

The edge kernel's message loss draws one Bernoulli keep mask per round
from a key it carries in its state (JAX ``models/rounds.py``: ``key, sub =
jax.random.split(key)``; ``keep = jax.random.bernoulli(sub, 1 - drop_rate,
(E,))``).  To replay a JAX run's loss realization — and so to compare a
lossy trajectory with the JAX package at all — this module computes the
same words: the Threefry-2x32 hash with 20 rounds (Salmon et al., SC'11)
and ``jax.random``'s key derivation in its ``jax_threefry_partitionable``
mode (the default of the JAX releases this repo runs):

* ``prng_key(seed)`` — the key ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``split(key, n)`` — key ``i`` is ``threefry(key, (0, i))``;
* ``fold_in(key, data)`` — ``threefry(key, (0, data mod 2^32))`` (the
  halo kernel gives shard ``s`` the key ``fold_in(PRNGKey(seed), s)``);
* ``bernoulli(key, p, n, dtype)`` — counter ``i`` hashes to ``(b1, b2)``;
  a float32 draw takes the word ``b1 ^ b2``, a float64 draw
  ``b1 << 32 | b2``; the mantissa bits become a uniform in [0, 1), and the
  mask is ``uniform < p``.  JAX draws in float64 under
  ``jax_enable_x64`` and in float32 without it.

Words are uint32 values held in int64 tensors (torch's uint32 has no
shifts), so the arithmetic is exact and masked back to 32 bits.  A key is
a ``(2,)`` int64 tensor.
"""

from __future__ import annotations

import torch

from flow_updating_tpu_torch.utils.device import resolve_device

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The 20-round Threefry-2x32 hash of the counter pairs ``(x1, x2)``
    under the key ``(k1, k2)`` (ints or 0-d tensors); uint32 words in
    int64 tensors, as ``jax``'s ``threefry2x32_p``."""
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=x1.device)
    k2 = torch.as_tensor(k2, dtype=torch.int64, device=x1.device)
    ks = [k1, k2, k1 ^ k2 ^ _PARITY]
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with a 64-bit seed: ``(2,)`` int64, on
    the card unless ``device='cpu'`` is given."""
    device = resolve_device(device)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def _counters(n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)`` int64."""
    hi, lo = _counters(num, key.device)
    a, b = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([a, b], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    pair ``(0, data)``, ``data`` taken as a uint32; ``(2,)`` int64."""
    x1 = torch.zeros(1, dtype=torch.int64, device=key.device)
    x2 = torch.full((1,), int(data) & _M32, dtype=torch.int64,
                    device=key.device)
    a, b = threefry2x32(key[0], key[1], x1, x2)
    return torch.cat([a, b])


def uniform(key: torch.Tensor, n: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), dtype)`` in [0, 1)."""
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        # (b1 << 32 | b2) >> 12, shifted in two parts to stay non-negative
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise ValueError(f"uniform draws float32 or float64, not {dtype}")


def bernoulli(key: torch.Tensor, p: float, n: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (n,))`` (mode 'low') with ``p`` of
    ``dtype``: ``(n,)`` bool."""
    return uniform(key, n, dtype) < torch.tensor(p, dtype=dtype,
                                                 device=key.device)
