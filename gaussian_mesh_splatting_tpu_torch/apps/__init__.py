"""Command-line entry points (python -m gaussian_mesh_splatting_tpu_torch.apps.<name>):
`train`, `render`, `render_flame`, `metrics`, `full_eval`, `render_animated`,
`render_mesh_morph`, `pseudomesh`, `convert`; `network_gui` is the viewer
bridge that `train --port` serves."""
