"""box-wge-524k: a box of warm water and dissolved air under an
atmospheric top, as a Waiwera JSON model.

Waiwera's input schema (eos "wge": water, air and energy; "beuler" time
stepping; deliverability and mass sources; Dirichlet boundaries) with
sizes that no published model fixes: this repository's flagship box,
128 x 64 x 64 hexahedra of 50 x 50 x 20 m (6.4 x 3.2 km, 1.28 km
deep), uniformly at 5 MPa and 220 C with air at 0.1 MPa, under a top
boundary of 1 bar, 20 C water held by 8,192 ghost cells, with a
deliverability producer in the top layer and a 20 kg/s injector at the
bottom. Every size is listed in ASSUMED. The Jacobian and BiCGStab with
block-Jacobi run in f32; the residual, the state and the Newton tests
stay f64. It is a frozen copy of the port's flagship model
(bench.flagship_config, chip_smoke.model_config), so that later changes
to those functions do not move the benchmark.

The model is the same for every seed: the seed draws only which steps
the reference judges (perfbench/lib/harness.py). The tries from the
initial state follow Newton's pass or fail at each step size, and a
scale of the rock's permeability by one part in a million already
moved them (37 to 43 tries an episode on the H100), so a seed that
changed the model would change the work.

`reference` gives the plain reference of this model's physics
(perfbench/reference/flow.py), which decides `correct`.
"""

GRID = (128, 64, 64)
CELL = (50.0, 50.0, 20.0)  # m
# what the configuration states, and what this repository assumed
ASSUMED = {
    "grid": "128 x 64 x 64 hexahedra, 50 x 50 x 20 m: this repository's flagship",
    "ghost_cells": "8,192: one per top face (atmospheric boundary)",
    "rock": "permeability 5e-14, 5e-14, 2e-14 m2, porosity 0.1, defaults otherwise",
    "initial": "5 MPa, 220 C, air partial pressure 0.1 MPa everywhere",
    "top": "1e5 Pa, 20 C, air partial pressure 1e3 Pa",
    "sources": "deliverability producer (PI 1e-12, 0.5 MPa) under the top centre; 20 kg/s of 500 kJ/kg water at the bottom",
    "solver": "f32 Jacobian and f32 BiCGStab + block-Jacobi, at least one Newton iteration",
}


def sizes(grid=GRID):
    """Counts that the benchmark's arithmetic needs: interior cells,
    ghost cells, primary variables, rows and interior faces."""
    nx, ny, nz = grid
    interior = nx * ny * nz
    ghosts = nx * ny
    faces = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    return {"grid": list(grid), "interior_cells": interior,
            "ghost_cells": ghosts, "primary_variables": 3,
            "rows": interior + ghosts, "interior_faces": faces,
            "linear_dtype": "float32"}


def build(seed: int, grid=GRID) -> dict:
    """The JSON model of this configuration (the same for every seed):
    its time section holds the solver only, and it has no output section
    (the workload adds the episode and the output)."""
    nx, ny, nz = grid
    n = nx * ny * nz
    top0 = n - nx * ny  # first cell of the top layer
    return {
        "title": f"box-wge-524k {nx} x {ny} x {nz}",
        "mesh": {"type": "rectangular", "dx": [CELL[0]] * nx,
                 "dy": [CELL[1]] * ny, "dz": [CELL[2]] * nz},
        "eos": {"name": "wge"},
        "initial": {"primary": [5.0e6, 220.0, 1.0e5], "region": 1},
        "rock": {"types": [{
            "name": "res",
            "permeability": [5e-14, 5e-14, 2e-14],
            "porosity": 0.1,
        }]},
        "boundaries": [{
            "primary": [1.0e5, 20.0, 1.0e3], "region": 1,
            "faces": {"cells": list(range(top0, n)),
                      "normal": [0.0, 0.0, 1.0]},
        }],
        "source": [
            {"cell": top0 + nx * (ny // 2) + nx // 2,
             "deliverability": {"productivity": 1e-12, "pressure": 5.0e5},
             "direction": "production"},
            {"cell": nx * (ny // 2) + nx // 4, "rate": 20.0,
             "enthalpy": 500.0e3},
        ],
        "time": {"step": {"solver": {
            "nonlinear": {"minimum": {"iterations": 1}},
            "linear": {"dtype": "float32", "jacobian_dtype": "float32",
                       "preconditioner": {"type": "bjacobi"}},
        }}},
    }


def reference(model: dict, device, dtype):
    """The plain reference of the model's physics, on `device` in
    `dtype`."""
    from perfbench.reference.flow import WGEBox

    return WGEBox(model, device, dtype)
