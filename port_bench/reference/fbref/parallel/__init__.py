from .mesh import Mesh, make_mesh
from .sharded import psum_stats, sharded_fill, split_index_by_code

__all__ = [
    "Mesh",
    "make_mesh",
    "sharded_fill",
    "psum_stats",
    "split_index_by_code",
]
