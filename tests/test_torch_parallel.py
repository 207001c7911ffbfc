"""The domain-decomposed step of waiwera_tpu_torch.parallel (gloo ranks
on the CPU, parallel/launch.py) against waiwera_tpu's DistributedSystem
at the same rank count (8 emulated CPU devices in this process) and
against the port on one device, on the models of tests/test_parallel.py.

- 48-cell column, bjacobi, D = 2 and 4: converged, Newton iterations
  equal to the JAX package's distributed step; y to rtol 1e-8 / atol
  1e-10, regions equal, balances to rtol 1e-7 / atol 1e-12
  (test_parallel.py:175-196), against both references.
- The same column with asm (the local DILU = restricted additive
  Schwarz), D = 4: y to rtol 3e-6 / atol 1e-8, and linear iterations at
  most 2 x the one-device count + 8 (test_parallel.py:236-241).
"""

import numpy as np
import pytest

from torch_ranks import (column_config, jax_dist, jparams, params,
                         port_ranks, port_single)


@pytest.fixture(scope="module")
def column_ranks():
    """The port's distributed column steps: D = 2 (bjacobi) and D = 4
    (bjacobi, asm), one launch each."""
    from waiwera_tpu_torch.mesh.rect import column_mesh

    cfg = column_config()
    return {
        2: dict(zip(["bjacobi"], port_ranks(
            cfg, column_mesh([10.0] * 48), [params("bjacobi")], 2)[0])),
        4: dict(zip(["bjacobi", "asm"], port_ranks(
            cfg, column_mesh([10.0] * 48),
            [params("bjacobi"), params("asm")], 4)[0])),
    }


@pytest.mark.parametrize("d", [2, 4])
def test_step_matches_jax_and_single(column_ranks, d):
    from waiwera_tpu.mesh.rect import column_mesh as jcol
    from waiwera_tpu_torch.mesh.rect import column_mesh as tcol

    cfg = column_config()
    r = column_ranks[d]["bjacobi"]
    assert r["converged"] and not r["failed"]
    assert r["route"] == "bands"

    res_j, y_j, reg_j, lhs_j = jax_dist(cfg, jcol([10.0] * 48),
                                         jparams("bjacobi"), d)
    assert r["iterations"] == int(res_j.iterations)
    np.testing.assert_allclose(r["y"], y_j, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(r["region"], reg_j)
    np.testing.assert_allclose(r["lhs"], lhs_j, rtol=1e-7, atol=1e-12)

    res1, lhs1 = port_single(cfg, tcol([10.0] * 48), params("bjacobi"))
    assert r["iterations"] == res1.iterations
    np.testing.assert_allclose(r["y"], res1.y.numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(r["region"], res1.region.numpy())
    np.testing.assert_allclose(r["lhs"], lhs1.numpy(), rtol=1e-7, atol=1e-12)


def test_dilu_matches_jax_and_single(column_ranks):
    from waiwera_tpu.mesh.rect import column_mesh as jcol
    from waiwera_tpu_torch.mesh.rect import column_mesh as tcol

    cfg = column_config()
    r = column_ranks[4]["asm"]
    assert r["converged"] and not r["failed"]
    _, y_j, _, _ = jax_dist(cfg, jcol([10.0] * 48), jparams("asm"), 4)
    np.testing.assert_allclose(r["y"], y_j, rtol=3e-6, atol=1e-8)
    res1, _ = port_single(cfg, tcol([10.0] * 48), params("asm"))
    np.testing.assert_allclose(r["y"], res1.y.numpy(), rtol=3e-6, atol=1e-8)
    assert r["linear_iterations"] <= 2 * res1.linear_iterations + 8
