"""waiwera_tpu_torch: the PyTorch/CUDA port of waiwera_tpu.

A JSON model of the flagship's kind (EOS wge with air, IAPWS-97, a
generated rectilinear or column mesh, deliverability producers and rate
injectors) runs on CPU or on one CUDA device: the adaptive timestepper
(backward Euler, BDF2, direct steady state) over an implicit step with
an f32 or f64 Jacobian and BiCGStab solve, HDF5 output, a YAML log,
restart and the command line (python -m waiwera_tpu_torch.cli).
Subpackages mirror the JAX package (thermo, eos, physics, mesh, ops,
solver, sim, utils) so that each module's counterpart is easy to find.

Importing this package imports torch and numpy only. It changes no
global dtype or device: every tensor is created with an explicit dtype
and device, and constants take the dtype and device of their input.
The banded block SpMV of the Krylov solve is a hand-written CUDA kernel
(csrc/dia_spmv.cu), built with nvcc at first use on a CUDA device.
"""

__version__ = "0.1.0"
