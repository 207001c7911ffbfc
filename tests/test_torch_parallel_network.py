"""One step of waiwera_tpu_torch.parallel over gloo ranks on the CPU
against waiwera_tpu's DistributedSystem at the same rank count and
against the port on one device.

- The source network of tests/test_parallel.py (deliverability,
  separators, a total limiter on a group, a reinjector) over D = 4
  ranks, one asm step of 1e3 s: y to rtol 3e-6 / atol 1e-8
  (test_parallel.py:324-326).
- A 6 x 4 x 3 wedge model from gmsh in RCM plan order over D = 2 ranks
  (the graph partitioner, local RCM and the ELL route), one lgmres + asm
  step: y to rtol 2e-5.
"""

import numpy as np

from chip_smoke import wedge_mesh, wedge_model_config, write_gmsh
from torch_ranks import jax_dist, jparams, params, port_ranks, port_single

NETWORK_CONFIG = {
    "eos": {"name": "we"},
    "initial": {"primary": [10.0e6, 250.0], "region": 1},
    "source": [
        {"name": "p1", "cell": 5,
         "deliverability": {"productivity": 1e-15, "pressure": 2e5},
         "separator": {"pressure": 0.55e6}},
        {"name": "p2", "cell": 35,
         "deliverability": {"productivity": 1e-15, "pressure": 2e5},
         "separator": {"pressure": 0.55e6}},
        {"name": "i1", "cell": 20, "rate": 0.05, "enthalpy": 400e3,
         "direction": "injection"},
    ],
    "network": {
        "group": [{"name": "wells", "in": ["p1", "p2"],
                   "limiter": {"type": "total", "limit": 100.0}}],
        "reinject": [{"name": "r1", "in": "wells",
                      "water": [{"out": "i1", "proportion": 0.5}]}],
    },
    "time": {"step": {"size": 1.0e3}},
}


def test_source_network_matches_jax_and_single():
    from waiwera_tpu.mesh.rect import column_mesh as jcol
    from waiwera_tpu_torch.mesh.rect import column_mesh as tcol

    dt = 1.0e3
    r = port_ranks(NETWORK_CONFIG, tcol([10.0] * 40), [params("asm")], 4,
                   dt=dt)[0][0]
    assert r["converged"] and not r["failed"]
    _, y_j, _, _ = jax_dist(NETWORK_CONFIG, jcol([10.0] * 40),
                            jparams("asm"), 4, dt=dt)
    np.testing.assert_allclose(r["y"], y_j, rtol=3e-6, atol=1e-8)
    res1, _ = port_single(NETWORK_CONFIG, tcol([10.0] * 40), params("asm"),
                          dt=dt)
    np.testing.assert_allclose(r["y"], res1.y.numpy(), rtol=3e-6, atol=1e-8)


def test_wedge_ell_route_matches_jax_and_single(tmp_path):
    from waiwera_tpu.mesh.gmsh import read_gmsh as jread
    from waiwera_tpu_torch.mesh.gmsh import read_gmsh as tread

    nx, ny, nz = 6, 4, 3
    v, w, pos = wedge_mesh(nx, ny, nz)
    fname = str(tmp_path / "field.msh")
    write_gmsh(fname, v, [("wedge", w)])
    cfg = wedge_model_config(fname, nx, ny, nz, pos)
    kw = dict(linear_method="lgmres")
    r = port_ranks(cfg, tread(fname), [params("asm", **kw)], 2)[0][0]
    assert r["converged"] and not r["failed"]
    assert r["route"] == "ell"
    _, y_j, _, _ = jax_dist(cfg, jread(fname), jparams("asm", **kw), 2)
    np.testing.assert_allclose(r["y"], y_j, rtol=2e-5)
    res1, _ = port_single(cfg, tread(fname), params("asm", **kw))
    np.testing.assert_allclose(r["y"], res1.y.numpy(), rtol=2e-5)
