"""A replica of the ``jax.random`` draws the reference solvers make.

With ``jax_threefry_partitionable`` (the default of current jax) every
draw reduces to one Threefry-2x32-20 call per element:

* ``prng_key(s)`` is the word pair ``[0, s]``;
* ``split(k, n)[i]`` is ``threefry(k, (0, i))``, both words;
* ``fold_in(k, d)`` is ``threefry(k, (0, d))``;
* ``bits(k, shape)`` at flat index ``i`` is ``x0 ^ x1`` of
  ``threefry(k, (0, i))``;
* ``uniform`` puts the top 23 bits under the exponent of 1.0
  (``(bits >> 9) | 0x3F800000`` read as f32) and subtracts 1;
* ``randint`` is jax's two-draw multiply-mod form, every product wrapped
  to 32 bits;
* ``permutation`` sorts by fresh 32-bit keys (stable), as jax's
  ``_shuffle`` does.

So the port replays the reference's random streams exactly, and the same
request gives the same permutation in both packages.  A key is a
``(..., 2)`` int64 tensor of uint32 words; every function here is
vectorised over the leading dims, so all chains draw in one call.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from ..kernels.prng import MASK32, threefry2x32

IntLike = Union[int, torch.Tensor]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} outside the int32 range")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _cipher(key: torch.Tensor, counter):
    """threefry(key, (0, counter)) with ``counter`` broadcast against the
    key's leading dims plus any trailing dims of its own."""
    extra = counter.dim() if isinstance(counter, torch.Tensor) else 0
    view = key.shape[:-1] + (1,) * extra
    return threefry2x32(key[..., 0].reshape(view), key[..., 1].reshape(view),
                        0, counter)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``(..., 2) -> (..., num, 2)``, as ``jax.random.split``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    x0, x1 = _cipher(key, i)
    return torch.stack([x0, x1], dim=-1)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``(..., 2) -> (..., 2)``, as ``jax.random.fold_in``."""
    x0, x1 = _cipher(key, torch.as_tensor(data, dtype=torch.int64,
                                          device=key.device) & MASK32)
    return torch.stack([x0, x1], dim=-1)


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element: ``(..., 2) -> (..., *shape)`` int64."""
    shape = tuple(shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    x0, x1 = _cipher(key, i)
    return (x0 ^ x1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """f32 uniforms in [0, 1): ``(..., 2) -> (..., *shape)``."""
    b = (bits(key, shape) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape: Sequence[int], minval: IntLike,
            maxval: IntLike) -> torch.Tensor:
    """int32 draws in [minval, maxval): ``(..., 2) -> (..., *shape)``.

    ``minval``/``maxval`` broadcast against the output (give a bound per
    key as ``bound[..., None]``).  Spans must fit the int32 range, as they
    do for jax's default int32 ``randint``.
    """
    k = split(key)
    hi = bits(k[..., 0, :], shape)
    lo = bits(k[..., 1, :], shape)
    dev = key.device
    minval = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    span = torch.where(maxval <= minval, 1, (maxval - minval) & MASK32)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    off = ((((hi % span) * mult) & MASK32) + lo % span) & MASK32
    return (minval + off % span).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``(..., 2) -> (..., n)`` int32."""
    x = torch.arange(n, dtype=torch.int32, device=key.device)
    x = x.expand(key.shape[:-1] + (n,))
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK32))
    for _ in range(rounds):
        k = split(key)
        key, sub = k[..., 0, :], k[..., 1, :]
        order = torch.argsort(bits(sub, (n,)), dim=-1, stable=True)
        x = torch.gather(x, -1, order)
    return x
