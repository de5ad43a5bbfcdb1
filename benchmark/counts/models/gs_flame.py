"""GaMeS on a FLAME head: the mesh's work (`gs_mesh`) and, per vertex, 400
blendshape multiply-adds a coordinate (2,400), 36 correctives a coordinate
(216), joint regression 30, skinning (a 3x4 blend of five joints 120,
applied 24), the axes and enlargement 6."""
from . import gs_mesh

VERTEX = 2 * 3 * 400 + 2 * 3 * 36 + 30 + 120 + 24 + 6


def model_flops(n_gaussians: int, n_faces: int, n_vertices: int) -> int:
    return gs_mesh.model_flops(n_gaussians, n_faces, n_vertices) + VERTEX * n_vertices
