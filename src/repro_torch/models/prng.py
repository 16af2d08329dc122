"""The threefry-2x32 key chain of ``jax.random``, by hand in PyTorch.

The JAX package samples through ``jax.random`` (threefry keys: ``key``,
``fold_in``, ``split``, ``categorical``). Sampled token streams can only be
compared with the JAX package's if the port draws the very same bits, so
this module reproduces the chain bit for bit, with JAX's defaults:

* ``threefry2x32``: Random123's Threefry-2x32 with 20 rounds, rotations
  (13, 15, 26, 6) and (17, 29, 16, 24), the parity constant ``0x1BD11BDA``,
  and a key injection after every 4 rounds.
* ``key(seed)``: the key of a Python integer seed as JAX makes it with
  64-bit types off (the default): the seed is read as a 32-bit integer, so
  the key is ``(0, seed mod 2**32)``.
* ``fold_in(key, d)``: ``threefry2x32(key, (0, d))``.
* ``split`` and ``random_bits``: the "partitionable" layout, JAX's default
  since 0.5 (``jax_threefry_partitionable``). New key ``i`` is the output
  pair at counters ``(0, i)``; 32 random bits ``i`` are the two output
  words XORed at counters ``(0, i)``.
* ``uniform``, ``gumbel`` (mode ``"low"``) and ``categorical``: float32
  from the top 23 bits, ``-log(-log(u))`` and the argmax of noise plus
  logits (the first index on ties).

Key data is an int64 tensor ``[..., 2]`` holding uint32 values: CUDA has
few unsigned 32-bit ops in PyTorch, so every add and rotate is done in
int64 and masked back to 32 bits. A right shift of a masked non-negative
int64 is logical. The integers are the same on the CPU and on CUDA; the
float ``log`` of the Gumbel noise may differ from XLA's by an ulp, which
can move an argmax only at a near tie.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32: the smallest normal number (``finfo.tiny``), the uniform's floor
F32_TINY = torch.finfo(torch.float32).tiny

Ints = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1: Ints, k2: Ints, x1: Ints, x2: Ints,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter pair (x1, x2) under the key (k1, k2),
    all uint32 values held in int64 tensors that broadcast together."""
    k1, k2, x1, x2 = (torch.as_tensor(v, dtype=torch.int64)
                      for v in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & M32
    return a, b


def key(seed: int, device="cpu") -> torch.Tensor:
    """Key data ``int64[2]`` of ``jax.random.key(seed)`` (64-bit types off:
    the seed is read as a 32-bit integer)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(key_data: torch.Tensor, data: Ints) -> torch.Tensor:
    """``jax.random.fold_in``: key data ``[..., 2]`` and uint32 ``data``
    (broadcast against the leading dims) -> new key data ``[..., 2]``."""
    d = torch.as_tensor(data, dtype=torch.int64,
                        device=key_data.device) & M32
    a, b = threefry2x32(key_data[..., 0], key_data[..., 1], 0, d)
    return torch.stack([a, b], dim=-1)


def _hash(key_data: torch.Tensor, n: int):
    """Both output words at the counters (0, 0) .. (0, n - 1) under each
    key: ``[..., n]`` each."""
    lo = torch.arange(n, dtype=torch.int64, device=key_data.device)
    return threefry2x32(key_data[..., 0:1], key_data[..., 1:2], 0, lo)


def split(key_data: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key data ``[..., 2]`` ->
    ``[..., num, 2]``."""
    a, b = _hash(key_data, num)
    return torch.stack([a, b], dim=-1)


def random_bits(key_data: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per draw (partitionable): key data ``[..., 2]`` ->
    uint32 values ``[..., n]`` in int64."""
    a, b = _hash(key_data, n)
    return a ^ b


def uniform(key_data: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``[..., n]`` draws in
    ``[minval, maxval)``."""
    bits = (random_bits(key_data, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key_data: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode ``"low"``: ``[..., n]``."""
    return -torch.log(-torch.log(uniform(key_data, n, minval=F32_TINY)))


def categorical(key_data: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per row: key
    data ``[..., 2]``, float32 logits ``[..., V]`` -> int64 ``[...]``, the
    Gumbel-max draw (the first index on ties)."""
    g = gumbel(key_data, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)
