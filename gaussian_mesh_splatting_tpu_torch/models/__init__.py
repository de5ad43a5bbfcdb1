"""Model registry: gs_type string -> parameterization module, each exposing
`to_bag(state, ...) -> GaussianBag` and its initializer.

Ported: `gs` (vanilla), `gs_flat`, `gs_mesh` and the render-only `gs_points`.
The JAX package's `gs_multi_mesh` and `gs_flame` raise.
"""
from . import flat, mesh, points, vanilla
from .gaussian_bag import GaussianBag, features_to_shs, shs_to_features

MODEL_REGISTRY = {
    "gs": vanilla,
    "gs_flat": flat,
    "gs_mesh": mesh,
    "gs_points": points,  # render-only
}


def get_model(gs_type: str):
    try:
        return MODEL_REGISTRY[gs_type]
    except KeyError:
        raise NotImplementedError(
            f"gs_type {gs_type!r} is not ported yet; ported: {sorted(MODEL_REGISTRY)}"
        ) from None
