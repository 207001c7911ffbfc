"""Multi-device domain decomposition over torch.distributed (counterpart
of waiwera_tpu/parallel; the reference's MPI parallelism, DMPlexDistribute
with overlap 1 and the PetscSF halo exchange, mesh.F90:143-171,
dm_utils.F90:1343-1448).

Cells are partitioned into per-rank blocks (partition.py, with the graph
routines of graph.py); each rank is a process (launch.py) that holds its
owned cells plus an overlap-1 halo, and the halo exchange and the
reductions are torch.distributed collectives (comm.py). spmd.py runs the
Newton step, the tracer solve and the Timestepper over the ranks.
"""

from waiwera_tpu_torch.parallel.partition import PartitionPlan, build_partition
from waiwera_tpu_torch.parallel.spmd import (
    DistributedSimulation,
    DistributedSystem,
)
