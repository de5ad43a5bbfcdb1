"""Command-line entry points. Ported so far: `render`
(python -m gaussian_mesh_splatting_tpu_torch.apps.render)."""
