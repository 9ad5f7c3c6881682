"""Data- and candidate-parallel execution over ranks (port of
genpose2_tpu/parallel/): ``mesh.py`` lays the ranks out and holds the
collectives, ``distributed.py`` joins a process group, ``launch.py`` starts
ranks on this machine."""

from genpose2_tpu_torch.parallel.mesh import (make_mesh, replicate, shard_batch,
                                              shard_candidates)

__all__ = ["make_mesh", "replicate", "shard_batch", "shard_candidates"]
