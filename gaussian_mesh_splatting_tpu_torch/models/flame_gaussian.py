"""`gs_flame`: Gaussians bound to a FLAME head mesh (port of
`gaussian_mesh_splatting_tpu/models/flame_gaussian.py`).

Differences from gs_mesh:
  * the vertices come from the FLAME decoder in every step, driven by the
    trainable shape / expression / pose / neck / translation params and a
    per-vertex enlargement (init 8.35);
  * the alpha is a softmax over the barycentric axis (not relu-normalize).

The rig's tensors are large static data, so the model is an instance: an
`nn.Module` that holds them as buffers on its device (`.to(device)`), with the
registry modules' interface (`to_bag`).
"""
from __future__ import annotations

import torch

from ..core.face_frames import face_scaling_rotation_quat
from ..core.sh import rgb_to_sh
from ..core.transforms import inverse_sigmoid
from .flame.decoder import FlameRig, flame_forward, transform_flame_vertices
from .flame.lbs import LbsModel
from .gaussian_bag import GaussianBag, features_to_shs
from .mesh import EPS_S0

_LANDMARKS = ("lmk_faces_idx", "lmk_bary_coords", "dynamic_lmk_faces_idx",
              "dynamic_lmk_bary_coords")


class FlameGaussianModel(torch.nn.Module):
    def __init__(self, rig: FlameRig, shape_dim: int = 100, expr_dim: int = 50):
        super().__init__()
        self.joint_parents = tuple(rig.parents)  # static; `parents` is the buffer
        self.shape_dim = shape_dim
        self.expr_dim = expr_dim
        for name, t in zip(LbsModel._fields, rig.lbs_model):
            self.register_buffer(name, t)
        for name in _LANDMARKS:
            self.register_buffer(name, getattr(rig, name))

    @property
    def rig(self) -> FlameRig:
        """The rig, on the module's device."""
        return FlameRig(LbsModel(*(getattr(self, k) for k in LbsModel._fields)),
                        self.joint_parents, *(getattr(self, k) for k in _LANDMARKS))

    def init_from_flame(
        self,
        alpha: torch.Tensor,  # (F, S, 3) raw
        colors: torch.Tensor,  # (F*S, 3)
        sh_degree: int = 3,
        vertices_enlargement_init: float = 8.35,
    ) -> dict:
        """The initial params, on the device of `alpha`."""
        f, s, _ = alpha.shape
        n = f * s
        k = (sh_degree + 1) ** 2
        dev = alpha.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        params = {
            "flame_shape": zeros(1, self.shape_dim),
            "flame_exp": zeros(1, self.expr_dim),
            "flame_pose": zeros(1, 6),
            "flame_neck_pose": zeros(1, 3),
            "flame_trans": zeros(1, 3),
            "vertices_enlargement": torch.full((self.v_template.shape[0], 3),
                                               vertices_enlargement_init, dtype=torch.float32,
                                               device=dev),
            "alpha": alpha.to(torch.float32),
            "scale": torch.ones((n, 1), dtype=torch.float32, device=dev),
            "f_dc": rgb_to_sh(colors.to(dev, torch.float32))[:, None, :],
            "f_rest": zeros(n, k - 1, 3),
            "opacity": inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=torch.float32, device=dev)),
        }
        consts = {"faces": self.faces.to(dev)}
        return {
            "params": params,
            "consts": consts,
            "alive": torch.ones((n,), dtype=torch.bool, device=dev),
        }

    def decode_vertices(self, params: dict) -> torch.Tensor:
        """FLAME forward + the scene transform -> (V, 3)."""
        vertices, _ = flame_forward(
            self.rig,
            params["flame_shape"],
            params["flame_exp"],
            params["flame_pose"],
            params["flame_neck_pose"],
            transl=params["flame_trans"],
        )
        return transform_flame_vertices(vertices, params["vertices_enlargement"])

    def to_bag(self, state: dict, vertices: torch.Tensor | None = None) -> GaussianBag:
        """`vertices` overrides the decoder's output (the animation hook)."""
        p = state["params"]
        if vertices is None:
            vertices = self.decode_vertices(p)
        triangles = vertices[state["consts"]["faces"].long()]
        alpha = torch.softmax(p["alpha"], dim=2)  # (F, S, 3)
        f, s, _ = alpha.shape
        n = f * s
        xyz = torch.einsum("fsa,fad->fsd", alpha, triangles).reshape(n, 3)
        face_scales, face_quats = face_scaling_rotation_quat(triangles, EPS_S0)
        scales_b = face_scales[:, None, :].expand(f, s, 3).reshape(n, 3)
        scaling = torch.relu(p["scale"] * scales_b) + EPS_S0
        rotation = face_quats[:, None, :].expand(f, s, 4).reshape(n, 4)
        return GaussianBag(
            xyz=xyz,
            scaling=scaling,
            rotation=rotation,
            opacity=torch.sigmoid(p["opacity"]),
            shs=features_to_shs(p["f_dc"], p["f_rest"]),
            alive=state["alive"],
        )
