"""Launch helpers (``repro.launch``'s port): ``mesh.make_host_mesh``."""

from repro_torch.launch.mesh import make_host_mesh

__all__ = ["make_host_mesh"]
