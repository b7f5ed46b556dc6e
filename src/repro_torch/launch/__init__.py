"""Launch helpers (``repro.launch``'s port): ``mesh.make_host_mesh``,
``mesh.make_production_mesh`` and the training launcher ``train``
(``python -m repro_torch.launch.train``)."""

from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
