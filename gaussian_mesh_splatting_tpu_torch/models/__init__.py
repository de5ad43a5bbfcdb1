"""Model registry: gs_type string -> parameterization module, each exposing
`to_bag(state, ...) -> GaussianBag` and its initializer.

`gs_flame` needs a FLAME rig, so it is an instance and not a module: build
`FlameGaussianModel(load_flame_pickle(path))` (and `register_model` it where
a caller looks models up by name), or take `model_for` the entry points'
way.
"""
from . import flat, mesh, multi_mesh, points, vanilla
from .flame_gaussian import FlameGaussianModel
from .gaussian_bag import GaussianBag, concat_bags, features_to_shs, shs_to_features

# every gs_type of the package: the registry's and `gs_flame`
GS_TYPES = ("gs", "gs_flat", "gs_mesh", "gs_multi_mesh", "gs_flame", "gs_points")

MODEL_REGISTRY = {
    "gs": vanilla,
    "gs_flat": flat,
    "gs_mesh": mesh,
    "gs_multi_mesh": multi_mesh,
    "gs_points": points,  # render-only
}


def get_model(gs_type: str):
    try:
        return MODEL_REGISTRY[gs_type]
    except KeyError:
        hint = (" (gs_flame needs a FLAME rig: FlameGaussianModel(load_flame_pickle(path)))"
                if gs_type == "gs_flame" else "")
        raise KeyError(f"unknown gs_type {gs_type!r}; known: {sorted(MODEL_REGISTRY)}"
                       f"{hint}") from None


def register_model(gs_type: str, module) -> None:
    MODEL_REGISTRY[gs_type] = module


def model_for(gs_type: str, flame_model: str | None = None, device=None):
    """(model, FLAME rig or None) for the entry points: the registry's
    module, or for `gs_flame` the model of the FLAME pickle `flame_model`
    on `device` with its rig (on the CPU, as the Blender_FLAME reader takes
    it)."""
    if gs_type != "gs_flame":
        return get_model(gs_type), None
    if not flame_model:
        raise ValueError("gs_flame needs a FLAME model pickle (--flame_model <pkl>)")
    from .flame import load_flame_pickle

    rig = load_flame_pickle(flame_model)
    return FlameGaussianModel(rig).to(device), rig
