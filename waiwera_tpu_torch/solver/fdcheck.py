"""Finite-difference Jacobian validation (counterpart of
waiwera_tpu/solver/fdcheck.py).

The reference builds its Jacobian by graph-colored finite differences
(timestepper.F90:1584-1607); the port assembles an exact AD block
Jacobian (solver/system.py). This check compares directional central
differences of the residual, evaluated at frozen regions as the
reference freezes them during its perturbations, against the assembled
BSR matrix-vector product.
"""

from __future__ import annotations

import numpy as np
import torch


def jacobian_fd_error(system, y, region, rock, coeffs, t0, t1,
                      num_probes: int = 4, h: float = 1e-6,
                      seed: int = 0) -> float:
    """Max relative error of the AD Jacobian against central differences
    over `num_probes` random directions, max_v |J v - FD_v| / |FD_v|.
    The directions are numpy RandomState(seed) normals on the rows that
    move in a Newton update, so the JAX package draws the same ones.

    Run in f64 (h = 1e-6 on the O(1) scaled primaries gives ~1e-8 of
    truncation); a healthy AD Jacobian scores below ~1e-5."""
    rng = np.random.RandomState(seed)
    _, _, _, _, mat = system.residual_and_jacobian(y, region, rock, coeffs,
                                                   t0, t1)
    mv = system.make_matvec(mat)
    mask = system.interior_mask.cpu().numpy()
    worst = 0.0
    for _ in range(num_probes):
        v = torch.as_tensor(rng.standard_normal(tuple(y.shape))
                            * mask[:, None], dtype=y.dtype, device=y.device)
        rp = system.residual(y + h * v, region, rock, coeffs, t0, t1)[0]
        rm = system.residual(y - h * v, region, rock, coeffs, t0, t1)[0]
        fd = (rp - rm) / (2.0 * h)
        num = float(torch.max(torch.abs(mv(v) - fd)))
        den = float(torch.max(torch.abs(fd))) or 1.0
        worst = max(worst, num / den)
    return worst
