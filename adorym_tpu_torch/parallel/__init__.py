"""Device meshes on ``torch.distributed`` (``adorym_tpu/parallel/``)."""
from .mesh import Mesh, make_mesh, shard_batch, shard_params  # noqa: F401
