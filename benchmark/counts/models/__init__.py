"""Each model kind's forward operations from its shapes, one file a kind
(`model_flops(n_gaussians, n_faces, n_vertices)`)."""
