"""Model registry: gs_type string -> parameterization module.

Only `gs_mesh` is ported so far; the other gs_types of the JAX package
(`gs`, `gs_flat`, `gs_multi_mesh`, `gs_points`, `gs_flame`) raise.
"""
from . import mesh
from .gaussian_bag import GaussianBag, features_to_shs, shs_to_features

MODEL_REGISTRY = {"gs_mesh": mesh}


def get_model(gs_type: str):
    try:
        return MODEL_REGISTRY[gs_type]
    except KeyError:
        raise NotImplementedError(
            f"gs_type {gs_type!r} is not ported yet; ported: {sorted(MODEL_REGISTRY)}"
        ) from None
