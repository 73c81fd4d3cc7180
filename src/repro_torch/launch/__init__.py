"""Entry points of the port."""
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]
