"""GaMeS on a mesh, per Gaussian: barycentric weights 10, centre 15, scales
9, opacity 4; per face: the frame and extents 60."""
GAUSSIAN, FACE = 38, 60


def model_flops(n_gaussians: int, n_faces: int, n_vertices: int) -> int:
    return GAUSSIAN * n_gaussians + FACE * n_faces
