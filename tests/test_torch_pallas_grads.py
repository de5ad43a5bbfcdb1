"""Gradients of the port's CPU rasterizer against `jax.grad` of the JAX
package's Pallas rasterizer in its exact mode (`interpret=True`,
`grad_precision="f32"`, `attr_precision="f32"`), on one scene: the path
whose backward kernel the port's csrc/composite_bwd.cu replaces. Tolerance
5e-4 * max|g| + 1e-7, the bound the JAX package holds that path to
(tests/test_raster_pallas.py). One case only: interpret-mode Pallas costs
~20 s to trace on the CPU."""
import torch

from test_torch_raster_grads import assert_grads_close, jax_grads, torch_grads

torch.set_num_threads(2)


def test_gradients_match_jax_pallas_exact_mode():
    assert_grads_close(torch_grads("aligned", "cuda_path"), jax_grads("aligned", "pallas"))
