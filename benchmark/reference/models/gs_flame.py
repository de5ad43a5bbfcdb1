"""`gs_flame`: the weights a softmax of alpha, the vertices from the FLAME
decoder: shape and expression blendshapes, pose correctives and linear blend
skinning over the five joints (the smplx formulation), moved to the scene's
axes and enlarged per vertex."""
import torch

from . import gaussians_on_faces


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """(n, 3) axis-angle -> (n, 3, 3), smplx's batch_rodrigues (the 1e-8
    inside the norm keeps the zero rotation differentiable)."""
    angle = torch.linalg.vector_norm(r + 1e-8, dim=1, keepdim=True)
    d = r / angle
    cos, sin = torch.cos(angle)[:, :, None], torch.sin(angle)[:, :, None]
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    o = torch.zeros_like(x)
    k = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=1).reshape(-1, 3, 3)
    return torch.eye(3, device=r.device) + sin * k + (1 - cos) * (k @ k)


def flame_vertices(p: dict, rig: dict) -> torch.Tensor:
    """FLAME at params (shape 100 of 300, expression 50 of 100, global and
    jaw pose, neck pose, translation; eyes at rest) -> (V, 3) scene
    vertices: FLAME's (x, y, z) becomes (x, -z, y), times the per-vertex
    enlargement."""
    dirs = rig["shapedirs"]
    n_shape = dirs.shape[-1] - 100
    dev = dirs.device
    betas = torch.cat([p["flame_shape"], torch.zeros(1, n_shape - p["flame_shape"].shape[1], device=dev),
                       p["flame_exp"], torch.zeros(1, 100 - p["flame_exp"].shape[1], device=dev)], 1)
    pose = torch.cat([p["flame_pose"][:, :3], p["flame_neck_pose"], p["flame_pose"][:, 3:],
                      torch.zeros(1, 6, device=dev)], 1)  # global, neck, jaw, eyes
    v_shaped = rig["v_template"] + torch.einsum("l,vkl->vk", betas[0], dirs)
    joints = rig["j_regressor"] @ v_shaped  # (J, 3)
    rots = rodrigues(pose.reshape(-1, 3))  # (J, 3, 3)
    feature = (rots[1:] - torch.eye(3, device=dev)).reshape(-1)
    v_posed = v_shaped + (feature @ rig["posedirs"]).reshape(-1, 3)
    parents = rig["parents"]
    rel = joints.clone()
    rel[1:] = joints[1:] - joints[list(parents[1:])]
    local = torch.cat([torch.cat([rots, rel[:, :, None]], 2),
                       torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(len(parents), 1, 4)], 1)
    chain = [local[0]]
    for j in range(1, len(parents)):
        chain.append(chain[parents[j]] @ local[j])
    world = torch.stack(chain)  # (J, 4, 4)
    offset = world[:, :3, :3] @ joints[:, :, None]  # the rest pose's joint, moved
    skin = torch.cat([world[:, :3, :3], world[:, :3, 3:] - offset], 2)  # (J, 3, 4)
    per_vertex = torch.einsum("vj,jab->vab", rig["lbs_weights"], skin)
    verts = (per_vertex[:, :, :3] @ v_posed[:, :, None])[:, :, 0] + per_vertex[:, :, 3]
    verts = verts + p["flame_trans"]
    scene = torch.stack([verts[:, 0], -verts[:, 2], verts[:, 1]], dim=1)
    return scene * p["vertices_enlargement"]


def bag(p: dict, faces: torch.Tensor, rig: dict) -> dict:
    verts = flame_vertices(p, rig)
    return gaussians_on_faces(verts[faces], torch.softmax(p["alpha"], dim=2), p)
