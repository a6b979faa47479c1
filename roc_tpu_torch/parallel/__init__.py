"""The parts of ``-parts N`` (roc_tpu/parallel/).

  mesh.py         the mesh positions and parts-per-position overcommit
  halo.py         the halo maps and each part's CSR over its table
  ring.py         the ring's owner groups and their CSRs
  wire.py         the exchanges' bf16 codec
  collectives.py  the process group and the exchanges across processes
  spmd.py         the SPMD trainer: vertex (halo, allgather), ring and
                  edge sharding, on one process or one a device
  check.py        sharded == single-device, on demand (-check-sharding)
  budget.py       per-device memory estimate before a build
"""

from roc_tpu_torch.parallel.halo import HaloMaps, build_halo_maps
from roc_tpu_torch.parallel.mesh import make_mesh

__all__ = ["HaloMaps", "build_halo_maps", "make_mesh"]
