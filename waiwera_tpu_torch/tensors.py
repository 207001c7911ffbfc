"""Constant tables as tensors in the dtype and device of an input.

The JAX package writes coefficient tables as numpy arrays and lets jnp
cast them; under its f32 Jacobian trace they silently become f32. Here
every table is converted explicitly to the dtype and device of the
tensor it meets, so an f32 chain stays f32 and an f64 chain stays f64.
Conversions are cached per (table, dtype, device): tables are
module-level constants, so each is copied to a device once.
"""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def const_like(table: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """`table` (a module-level numpy constant) as a tensor with the
    floating dtype and the device of `like`."""
    key = (id(table), like.dtype, like.device)
    hit = _CACHE.get(key)
    if hit is None:
        # the table is kept in the entry so that its id stays unique
        hit = (table, torch.as_tensor(table, dtype=like.dtype,
                                      device=like.device))
        _CACHE[key] = hit
    return hit[1]


def index_on(table: np.ndarray, device) -> torch.Tensor:
    """Integer `table` (a module-level numpy constant) as an int64
    index tensor on `device`."""
    device = torch.device(device)
    key = (id(table), torch.int64, device)
    hit = _CACHE.get(key)
    if hit is None:
        hit = (table, torch.as_tensor(table, dtype=torch.int64,
                                      device=device))
        _CACHE[key] = hit
    return hit[1]


# Bounds with the JAX package's derivative at a tie: jnp.clip is
# minimum(maximum(x, lo), hi), and jnp.maximum/minimum split the tangent
# equally between the two arguments where they are equal (torch.clamp
# passes all of it). States sit on such ties (a zero gas partial
# pressure, a zero salt mass fraction), so the EOS chains use these.

def _bound(x: torch.Tensor, v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else x.new_full((), float(v))


def maximum(x: torch.Tensor, v) -> torch.Tensor:
    """jnp.maximum(x, v) for a tensor x and a tensor or number v."""
    return torch.maximum(x, _bound(x, v))


def minimum(x: torch.Tensor, v) -> torch.Tensor:
    """jnp.minimum(x, v) for a tensor x and a tensor or number v."""
    return torch.minimum(x, _bound(x, v))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip(x, lo, hi); lo and hi are tensors or numbers."""
    return minimum(maximum(x, lo), hi)
