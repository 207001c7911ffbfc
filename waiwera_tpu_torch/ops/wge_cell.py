"""The Jacobian's cell chain for the water, air and energy EOS as one
hand-written CUDA kernel (csrc/wge_cell_jvp.cu).

System.jacobian_parts differentiates its cell chain (eos.unscale, the
EOS properties, the conductivity and the cell balances) in forward mode:
the primal and one tangent per primary variable. Its plain version,
System.cell_jvp, is torch.func.vmap(torch.func.jvp(cell_chain)) and
streams every intermediate with its tangents through device memory. On
the route this module covers (route: EOSWaterGasEnergy with air on
IAPWS-97, fully mobile relative permeability and zero capillarity, CUDA
tensors) the kernel computes the same chain in one pass, a dual number
per row in registers, and writes only what the face chain takes: the
fluid's floating fields and their tangents, the conductivity and its
tangents, and the balances' tangents dL, as views of two buffers
(LAYOUT). The fluid's phase composition comes from the kernel; its
regions are the input's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from waiwera_tpu_torch.ops.dia import LaunchCount
from waiwera_tpu_torch.physics.state import INT_FIELDS, FluidState

# launches of csrc/wge_cell_jvp.cu (one per Jacobian on the kernel route)
wge_cell_jvp_launches = LaunchCount()

NPV = 3
# FluidState's floating fields in field order with their trailing shapes
# (2 phases, 2 components), then the conductivity: each field a row-major
# [n, *shape] block of the primal buffer at its column offset times n (the
# kernel's enum Column)
LAYOUT = (
    ("pressure", ()),
    ("temperature", ()),
    ("permeability_factor", ()),
    ("partial_pressure", (2,)),
    ("density", (2,)),
    ("viscosity", (2,)),
    ("saturation", (2,)),
    ("relative_permeability", (2,)),
    ("capillary_pressure", (2,)),
    ("specific_enthalpy", (2,)),
    ("internal_energy", (2,)),
    ("mass_fraction", (2, 2)),
    ("conductivity", ()),
)
PRIMAL_COLUMNS = 24  # the fields above
TANGENT_COLUMNS = PRIMAL_COLUMNS + NPV  # and dL [n, npv]

_FUNCTIONS = {torch.float32: "wge_cell_jvp_f32",
              torch.float64: "wge_cell_jvp_f64"}


def route(eos, device) -> bool:
    """The kernel route: the EOS is water, air and energy ("wge" with
    air, or "wae") on IAPWS-97 with fully mobile relative permeability
    and zero capillary pressure, and the device is a CUDA device."""
    from waiwera_tpu_torch.eos.wge import EOSWaterGasEnergy
    from waiwera_tpu_torch.physics.capillarity import Zero
    from waiwera_tpu_torch.physics.relperm import FullyMobile
    from waiwera_tpu_torch.thermo.iapws97 import IAPWS97
    from waiwera_tpu_torch.thermo.ncg import AirNCG

    return (torch.device(device).type == "cuda"
            and type(eos) is EOSWaterGasEnergy and type(eos.gas) is AirNCG
            and type(eos.thermo) is IAPWS97
            and type(eos.relative_permeability) is FullyMobile
            and type(eos.capillary_pressure) is Zero)


class CellJVP(NamedTuple):
    """The cell chain at y and its tangents, as System.cell_jvp returns
    them: floats in FluidState's field order [n, ...], cond [n], their
    tangents [npv, n, ...], and dL [npv, n, npv]."""

    floats: tuple
    cond: torch.Tensor
    d_fluid: tuple
    d_cond: torch.Tensor
    dL: torch.Tensor
    phase_composition: torch.Tensor  # [n] int32

    def fluid(self, region: torch.Tensor) -> FluidState:
        """The FluidState of the primal at `region`."""
        region32 = region.to(torch.int32)
        ints = {"region": region32, "old_region": region32,
                "phase_composition": self.phase_composition}
        it = iter(self.floats)
        return FluidState(*(ints[k] if k in INT_FIELDS else next(it)
                            for k in FluidState._fields))


def views(primal, tangent, phases) -> CellJVP:
    """The CellJVP whose tensors are views of the kernel's output buffers
    (primal [PRIMAL_COLUMNS n], tangent [npv, TANGENT_COLUMNS n], phases
    [n] int32), at its column offsets."""
    n = phases.shape[0]
    out, d_out = [], []
    col = 0
    for _, shape in LAYOUT:
        width = 1
        for s in shape:
            width *= s
        out.append(primal[col * n:(col + width) * n].view(n, *shape))
        d_out.append(tangent[:, col * n:(col + width) * n]
                     .view(NPV, n, *shape))
        col += width
    return CellJVP(floats=tuple(out[:-1]), cond=out[-1],
                   d_fluid=tuple(d_out[:-1]), d_cond=d_out[-1],
                   dL=tangent[:, col * n:(col + NPV) * n].view(NPV, n, NPV),
                   phase_composition=phases)


class _Params(ctypes.Structure):
    _fields_ = [("scale", ctypes.c_double * 12),
                ("region1_max_temperature", ctypes.c_double),
                ("air_enthalpy_shift", ctypes.c_double),
                ("air_fmix", ctypes.c_double),
                ("air_cmix", ctypes.c_double),
                ("adaptive_pp_scale", ctypes.c_int)]


def wge_params(eos) -> _Params:
    """The kernel's scalars from the EOS and its thermodynamics and gas."""
    p = _Params()
    p.scale[:] = [float(v) for v in eos.primary_scale.reshape(-1)]
    p.region1_max_temperature = float(eos.thermo.region1_max_temperature)
    p.air_enthalpy_shift = float(eos.gas._enthalpy_shift)
    p.air_fmix = float(eos.gas._fmix)
    p.air_cmix = float(eos.gas._cmix)
    p.adaptive_pp_scale = int(bool(eos.adaptive_pp_scale))
    return p


_fns: dict = {}


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        from waiwera_tpu_torch.ops import cuda_build

        fn = getattr(cuda_build.load("wge_cell_jvp"), _FUNCTIONS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.POINTER(_Params), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _launch(params, y, region, rock, is_ghost, primal, tangent, phases, err):
    """Run the kernel on CUDA tensors (raises on any other device)."""
    if y.device.type != "cuda":
        raise ValueError(f"wge_cell_jvp: tensors on {y.device}; the kernel "
                         "takes CUDA tensors (System.cell_jvp is its plain "
                         "version)")
    fields = (y, region, rock.porosity, rock.density, rock.specific_heat,
              rock.wet_conductivity, rock.dry_conductivity, is_ghost)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(primal.dtype)(
            *(t.data_ptr() for t in fields), ctypes.byref(params),
            primal.data_ptr(), tangent.data_ptr(), phases.data_ptr(),
            None if err is None else err.data_ptr(), y.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"{_FUNCTIONS[primal.dtype]} launch failed: CUDA "
                           f"error {rc}")


def cell_jvp(params, y, region, rock, is_ghost, dtype, err=None) -> CellJVP:
    """The cell chain at y [n, npv] and its npv tangents (seed v: y[:, v])
    in `dtype` (f32 or f64), from the f64 state: region [n], the rock's f64
    fields and is_ghost [n] (balances' tangents zero there), all on one
    CUDA device. params: wge_params(eos). err, a bool tensor [n], receives
    the EOS error flag of eos.properties."""
    if dtype not in _FUNCTIONS:
        raise TypeError(f"wge_cell_jvp: tangent dtype {dtype}; f32 or f64")
    n = y.shape[0]
    if tuple(y.shape) != (n, NPV):
        raise ValueError(f"wge_cell_jvp: y shape {tuple(y.shape)}")

    def f64(t):
        t = t.to(torch.float64).contiguous()
        if tuple(t.shape) != (n,) or t.device != y.device:
            raise ValueError(f"wge_cell_jvp: a field of shape "
                             f"{tuple(t.shape)} on {t.device}")
        return t

    rock = rock._replace(**{k: f64(getattr(rock, k)) for k in (
        "porosity", "density", "specific_heat", "wet_conductivity",
        "dry_conductivity")})
    region = region.to(torch.int32).contiguous()
    is_ghost = is_ghost.to(torch.bool).contiguous()
    if (tuple(region.shape) != (n,) or tuple(is_ghost.shape) != (n,)
            or (err is not None and (err.dtype != torch.bool
                                     or tuple(err.shape) != (n,)))):
        raise ValueError("wge_cell_jvp: region, is_ghost and err take [n]")
    primal = torch.empty(PRIMAL_COLUMNS * n, dtype=dtype, device=y.device)
    tangent = torch.empty((NPV, TANGENT_COLUMNS * n), dtype=dtype,
                          device=y.device)
    phases = torch.empty(n, dtype=torch.int32, device=y.device)
    _launch(params, y.to(torch.float64).contiguous(), region, rock,
            is_ghost, primal, tangent, phases, err)
    wge_cell_jvp_launches.count += 1
    return views(primal, tangent, phases)
