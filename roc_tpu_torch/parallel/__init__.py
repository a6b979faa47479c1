"""The parts of ``-parts N`` on one device (roc_tpu/parallel/).

  mesh.py    the mesh positions and parts-per-position overcommit
  halo.py    the halo maps and each part's CSR over its table
  wire.py    the exchanges' bf16 codec
  spmd.py    the vertex-sharded SPMD trainer
  check.py   sharded == single-device, on demand (-check-sharding)
  budget.py  per-device memory estimate before a build
"""

from roc_tpu_torch.parallel.halo import HaloMaps, build_halo_maps
from roc_tpu_torch.parallel.mesh import make_mesh

__all__ = ["HaloMaps", "build_halo_maps", "make_mesh"]
