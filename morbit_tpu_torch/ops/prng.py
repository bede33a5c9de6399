"""The reference's ``jax.random`` draws, bit for bit, in integer torch ops.

The JAX package draws the random round-4 candidates of
``RbfConfig(use_max_points=True)`` with ``jax.random`` (threefry2x32, the
default implementation, with ``jax_threefry_partitionable`` on). This module
reproduces the calls it makes:

* :func:`prng_key` — ``jax.random.PRNGKey(seed)``;
* :func:`fold_in` — ``jax.random.fold_in(key, data)``;
* :func:`split` — ``jax.random.split(key, num)``;
* :func:`uniform` — ``jax.random.uniform(key, shape, dtype)`` on [0, 1) at
  float32 and float64.

A key is a pair of uint32 words, held here as int64 values in [0, 2^32)
(torch's unsigned 32-bit type has too few operations); every uint32 sum
and shift is masked back to 32 bits. Keys carry a leading lane axis:
``(B, 2)`` keys give ``(B, ...)`` draws, each lane from its own key.
Integer operations round nowhere, so the card and the CPU draw the same
bits.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the count words ``(x1, x2)`` under the key
    ``(k1, k2)`` (20 rounds, ``jax._src.prng._threefry2x32_lowering``); all
    arguments broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``PRNGKey(seed)``: the (2,) key ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``fold_in(key, data)`` for keys ``(..., 2)`` and uint32 data (an int
    or a tensor broadcasting against the keys' leading axes): the hash of
    the count pair ``(0, data)``."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``split(key, num)`` for keys ``(..., 2)`` -> ``(..., num, 2)``: key i
    is the hash of the count pair ``(0, i)``."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., None, 0], key[..., None, 1],
                          torch.zeros_like(counts), counts)
    return torch.stack([o1, o2], dim=-1)


def uniform(key: torch.Tensor, shape, dtype) -> torch.Tensor:
    """``uniform(key, shape, dtype)`` on [0, 1) for keys ``(..., 2)`` ->
    ``(..., *shape)``: the hash of the flat row-major counts, its mantissa
    bits under exponent 0, minus 1 (``jax._src.random._uniform``)."""
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    if size >= 2 ** 32:
        raise NotImplementedError("uniform draws of 2^32 values or more")
    counts = torch.arange(size, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., None, 0], key[..., None, 1],
                          torch.zeros_like(counts), counts)
    if dtype == torch.float64:
        # the 64 random bits (b1 << 32 | b2) shifted right by 12
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        floats = bits.view(torch.float64)
    elif dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        floats = bits.to(torch.int32).view(torch.float32)
    else:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    return (floats - 1.0).reshape(key.shape[:-1] + shape)


def float_to_uint32(v: torch.Tensor) -> torch.Tensor:
    """XLA's float -> uint32 conversion as int64 values: truncation toward
    zero, saturating at 0 and 2^32 - 1, NaN to 0."""
    v = torch.nan_to_num(v, nan=0.0)
    return torch.clamp(torch.trunc(v.double()), 0.0, float(_MASK)).to(torch.int64)
