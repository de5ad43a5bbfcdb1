"""The port's FLAME decoder and `gs_flame` model against the JAX package on
the CPU, on the same rig (the JAX package's `make_random_flame_like_rig`,
carried over with `interop.flame_rig_from_numpy`) and the same numpy-seeded
inputs: Rodrigues, forward kinematics, LBS, `flame_forward` with static and
dynamic landmarks, the FLAME pickle and landmark loaders, `to_bag` and the
gradients of a render loss into every FLAME param, one `gs_flame` train
step, and the Blender_FLAME reader.

Tolerances and why:
  * decoder: 1e-5 of each output's largest magnitude: the 400-direction
    blend and the 36 x 3V pose correctives are float32 sums in another order
    than XLA's (about 1e-6 relative measured);
  * the dynamic-landmark bucket: exact (both round half to even);
  * `to_bag`: 1e-5 of each field's scale (it runs the decoder);
  * gradients: 5e-4 * max|g| per param, the rasterizer's gradient bound;
  * one step: loss 1e-5 relative, gradients as above;
  * the reader: exact for the seeds, colours and cameras (the same numpy
    draws), 1e-5 for the decoded template.
"""
import importlib
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussian_mesh_splatting_tpu.models.flame import decoder as jdec
jlbs = importlib.import_module("gaussian_mesh_splatting_tpu.models.flame.lbs")
from gaussian_mesh_splatting_tpu.models.flame_gaussian import FlameGaussianModel as JFlameModel
from gaussian_mesh_splatting_tpu.renderer import render as j_render
from gaussian_mesh_splatting_tpu.scene import Scene as JScene
from gaussian_mesh_splatting_tpu.scene import dataset_readers as j_readers
from gaussian_mesh_splatting_tpu.train import loss as j_loss
from gaussian_mesh_splatting_tpu.train import make_train_state as j_make_train_state
from gaussian_mesh_splatting_tpu.train import make_train_step as j_make_train_step
from gaussian_mesh_splatting_tpu.train import optimization_config as j_optimization_config
from gaussian_mesh_splatting_tpu_torch.interop import (
    flame_rig_from_numpy,
    state_from_numpy,
    train_state_from_numpy,
)
from gaussian_mesh_splatting_tpu_torch.models import FlameGaussianModel
from gaussian_mesh_splatting_tpu_torch.models.flame import decoder as tdec
tlbs = importlib.import_module("gaussian_mesh_splatting_tpu_torch.models.flame.lbs")
from gaussian_mesh_splatting_tpu_torch.renderer import render as t_render
from gaussian_mesh_splatting_tpu_torch.scene import Scene
from gaussian_mesh_splatting_tpu_torch.scene import dataset_readers as t_readers
from gaussian_mesh_splatting_tpu_torch.train import (
    make_train_state,
    make_train_step,
    optimization_config,
    photometric_loss,
)

from test_models import _icosahedron
from test_torch_multi_mesh import jax_camera, to_torch_camera, train_state_numpy, tree_np

torch.set_num_threads(2)
SH = 1
FLAME_PARAMS = ("flame_shape", "flame_exp", "flame_pose", "flame_neck_pose", "flame_trans",
                "vertices_enlargement")


def _rel_close(t, j, rtol=1e-5, msg=""):
    t, j = t.detach().numpy(), np.asarray(j)
    scale = max(float(np.abs(j).max()), 1e-12)
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * scale, err_msg=msg)


def rig_numpy(jrig) -> dict:
    """A JAX FlameRig -> the mapping `flame_rig_from_numpy` takes."""
    out = {k: np.asarray(v) for k, v in jrig.lbs_model._asdict().items()}
    for k in ("lmk_faces_idx", "lmk_bary_coords", "dynamic_lmk_faces_idx",
              "dynamic_lmk_bary_coords"):
        v = getattr(jrig, k)
        out[k] = None if v is None else np.asarray(v)
    return out


def jax_rig(n_verts=64, seed=0, landmarks=False):
    rig = jdec.make_random_flame_like_rig(jax.random.key(seed), n_verts=n_verts)
    if landmarks:
        rng = np.random.default_rng(seed)
        n_faces = int(rig.lbs_model.faces.shape[0])
        bary = rng.random((79, 4, 3)).astype(np.float32)
        rig = rig._replace(
            lmk_faces_idx=rng.integers(0, n_faces, 6).astype(np.int64),
            lmk_bary_coords=rng.dirichlet(np.ones(3), 6).astype(np.float32),
            dynamic_lmk_faces_idx=rng.integers(0, n_faces, (79, 4)).astype(np.int64),
            dynamic_lmk_bary_coords=bary / bary.sum(-1, keepdims=True),
        )
    return rig


def both_rigs(**kw):
    jr = jax_rig(**kw)
    return jr, flame_rig_from_numpy(rig_numpy(jr), device="cpu")


def icosphere(subdivisions=1, radius=0.1):
    """A closed sphere mesh (42 vertices and 80 faces at one subdivision)."""
    verts, faces = _icosahedron()
    verts, faces = np.asarray(verts, np.float64), np.asarray(faces)
    for _ in range(subdivisions):
        vlist, cache, new_faces = list(verts), {}, []

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                cache[key] = len(vlist)
                vlist.append((verts[i] + verts[j]) / 2)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts, faces = np.array(vlist), np.array(new_faces)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return verts.astype(np.float32), faces.astype(np.int32)


def head_rigs(seed=6, mesh=None):
    """FLAME's structure on a closed mesh, by default a sphere (the random
    rig's triangulation holds degenerate faces, whose face frames amplify
    rounding): the rendering tests' rig, in both packages."""
    verts, faces = icosphere() if mesh is None else mesh
    jr = jax_rig(n_verts=verts.shape[0], seed=seed)
    jr = jr._replace(lbs_model=jr.lbs_model._replace(v_template=jnp.asarray(verts),
                                                    faces=jnp.asarray(faces)))
    return jr, flame_rig_from_numpy(rig_numpy(jr), device="cpu")


def test_batch_rodrigues_matches_jax():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.standard_normal((64, 3)), np.zeros((1, 3)),
                        rng.standard_normal((4, 3)) * 1e-4]).astype(np.float32)
    _rel_close(tlbs.batch_rodrigues(torch.tensor(v)), jlbs.batch_rodrigues(jnp.asarray(v)))
    # the gradient at the zero rotation (the eps inside the norm keeps it finite)
    w = rng.standard_normal((1, 3, 3)).astype(np.float32)
    zero = torch.zeros((1, 3), requires_grad=True)
    (tlbs.batch_rodrigues(zero) * torch.tensor(w)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(jlbs.batch_rodrigues(x) * w))(jnp.zeros((1, 3)))
    assert torch.isfinite(zero.grad).all() and float(zero.grad.abs().max()) > 0
    _rel_close(zero.grad, jg)


def test_batch_rigid_transform_matches_jax():
    rng = np.random.default_rng(1)
    rots = jlbs.batch_rodrigues(jnp.asarray(rng.standard_normal((10, 3)).astype(np.float32)))
    rots = np.asarray(rots).reshape(2, 5, 3, 3)
    joints = rng.standard_normal((2, 5, 3)).astype(np.float32)
    jp, ja = jlbs.batch_rigid_transform(jnp.asarray(rots), jnp.asarray(joints),
                                        jdec.FLAME_PARENTS)
    tp, ta = tlbs.batch_rigid_transform(torch.tensor(rots), torch.tensor(joints),
                                        tdec.FLAME_PARENTS)
    _rel_close(tp, jp)
    _rel_close(ta, ja)


def test_lbs_matches_jax():
    jr, tr = both_rigs(n_verts=96)
    m, tm = jr.lbs_model, tr.lbs_model
    rng = np.random.default_rng(2)
    betas = (rng.standard_normal((2, 400)) * 0.5).astype(np.float32)
    pose = (rng.standard_normal((2, 15)) * 0.3).astype(np.float32)
    jv, jj = jlbs.lbs(jnp.asarray(betas), jnp.asarray(pose), m.v_template, m.shapedirs,
                      m.posedirs, m.j_regressor, jr.parents, m.lbs_weights)
    tv, tj = tlbs.lbs(torch.tensor(betas), torch.tensor(pose), tm.v_template, tm.shapedirs,
                      tm.posedirs, tm.j_regressor, tr.parents, tm.lbs_weights)
    _rel_close(tv, jv)
    _rel_close(tj, jj)
    # the zero pose and zero betas give the template
    tv0, _ = tlbs.lbs(torch.zeros((1, 400)), torch.zeros((1, 15)), tm.v_template, tm.shapedirs,
                      tm.posedirs, tm.j_regressor, tr.parents, tm.lbs_weights)
    np.testing.assert_allclose(tv0[0].numpy(), tm.v_template.numpy(), atol=1e-5)


@pytest.mark.parametrize("landmarks", [False, True], ids=["no_landmarks", "landmarks"])
def test_flame_forward_matches_jax(landmarks):
    jr, tr = both_rigs(n_verts=96, landmarks=landmarks)
    rng = np.random.default_rng(3)
    args = [(rng.standard_normal((2, n)) * s).astype(np.float32)
            for n, s in ((100, 0.5), (50, 0.5), (6, 0.3), (3, 0.3), (6, 0.2), (3, 0.1))]
    jv, jl = jdec.flame_forward(jr, *map(jnp.asarray, args[:4]), eye_pose=jnp.asarray(args[4]),
                                transl=jnp.asarray(args[5]))
    tv, tl = tdec.flame_forward(tr, *map(torch.tensor, args[:4]), eye_pose=torch.tensor(args[4]),
                                transl=torch.tensor(args[5]))
    _rel_close(tv, jv)
    assert (tl is None) == (jl is None) == (not landmarks)
    if landmarks:
        assert tl.shape == (2, 4 + 6, 3)
        _rel_close(tl, jl)
    # transl moves every vertex by itself
    tv0, _ = tdec.flame_forward(tr, *map(torch.tensor, args[:4]), eye_pose=torch.tensor(args[4]))
    np.testing.assert_allclose((tv - tv0).numpy(), np.broadcast_to(args[5][:, None], tv.shape),
                               atol=1e-5)


def test_dynamic_landmark_bucket_matches_jax():
    """The neck's yaw picks the contour bucket: a sweep of yaws from -60 to
    60 degrees, some of them on half degrees."""
    jr, tr = both_rigs(landmarks=True)
    yaws = np.concatenate([np.linspace(-60, 60, 97), np.arange(-40.5, 41, 1.0)])
    pose = np.zeros((len(yaws), 15), np.float32)
    pose[:, 4] = np.deg2rad(yaws)  # the neck's y axis
    pose[:, 0] = 0.05  # a little root roll
    jidx, jb = jdec.find_dynamic_lmk_idx_and_bcoords(
        jr, jnp.asarray(pose), jnp.asarray(jr.dynamic_lmk_faces_idx, jnp.int32),
        jnp.asarray(jr.dynamic_lmk_bary_coords))
    tidx, tb = tdec.find_dynamic_lmk_idx_and_bcoords(
        tr, torch.tensor(pose), tr.dynamic_lmk_faces_idx, tr.dynamic_lmk_bary_coords)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert len(np.unique(tidx.numpy()[:, 0])) > 40  # many buckets visited


def write_flame_pickle(path, jrig):
    """`jrig` in the real FLAME file's format: float64 arrays, posedirs as
    (V, 3, P), faces uint32, and the root's parent as the file writes it
    (2**32 - 1 in a uint32 kintree table)."""
    m = jrig.lbs_model
    nv = m.v_template.shape[0]
    n_pose = m.posedirs.shape[0]
    kintree = np.stack([np.asarray(jrig.parents), np.arange(len(jrig.parents))]).astype(np.int64)
    kintree[0, 0] = 2**32 - 1
    data = {
        "kintree_table": kintree.astype(np.uint32),
        "v_template": np.asarray(m.v_template, np.float64),
        "shapedirs": np.asarray(m.shapedirs, np.float64),
        "posedirs": np.asarray(m.posedirs, np.float64).T.reshape(nv, 3, n_pose),
        "J_regressor": np.asarray(m.j_regressor, np.float64),
        "weights": np.asarray(m.lbs_weights, np.float64),
        "f": np.asarray(m.faces).astype(np.uint32),
    }
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def test_load_flame_pickle_matches_jax(tmp_path):
    jr = jax_rig(n_verts=80, seed=4)
    path = write_flame_pickle(str(tmp_path / "flame.pkl"), jr)
    ref, got = jdec.load_flame_pickle(path), tdec.load_flame_pickle(path)
    assert got.parents == ref.parents == jdec.FLAME_PARENTS
    for k, v in ref.lbs_model._asdict().items():
        t = getattr(got.lbs_model, k)
        np.testing.assert_array_equal(t.numpy(), np.asarray(v), err_msg=k)
        assert t.dtype == (torch.int64 if k in ("parents", "faces") else torch.float32), k
    # the loaded rig decodes as the one it was written from
    args = [torch.full((1, n), 0.3) for n in (100, 50, 6, 3)]
    tv, _ = tdec.flame_forward(got, *args)
    jv, _ = jdec.flame_forward(jr, *(jnp.full((1, n), 0.3) for n in (100, 50, 6, 3)))
    _rel_close(tv, jv)


def test_landmark_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    static = {"lmk_face_idx": rng.integers(0, 100, 51).astype(np.uint32),
              "lmk_b_coords": rng.random((51, 3))}
    with open(tmp_path / "static.pkl", "wb") as f:
        pickle.dump(static, f)
    dynamic = {"lmk_face_idx": rng.integers(0, 100, (79, 17)),
               "lmk_b_coords": rng.random((79, 17, 3))}
    np.save(tmp_path / "dynamic.npy", dynamic, allow_pickle=True)
    jr, tr = both_rigs()
    jr = jdec.load_dynamic_landmarks(jdec.load_static_landmarks(jr, str(tmp_path / "static.pkl")),
                                     str(tmp_path / "dynamic.npy"))
    tr = tdec.load_dynamic_landmarks(tdec.load_static_landmarks(tr, str(tmp_path / "static.pkl")),
                                     str(tmp_path / "dynamic.npy"))
    for k in ("lmk_faces_idx", "lmk_bary_coords", "dynamic_lmk_faces_idx",
              "dynamic_lmk_bary_coords"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)))


def test_random_rig_has_flames_structure():
    g = torch.Generator().manual_seed(3)
    rig = tdec.make_random_flame_like_rig(g, n_verts=40)
    m = rig.lbs_model
    assert rig.parents == tdec.FLAME_PARENTS
    assert m.shapedirs.shape == (40, 3, 400) and m.posedirs.shape == (36, 120)
    assert m.j_regressor.shape == (5, 40) and m.lbs_weights.shape == (40, 5)
    assert m.faces.shape == (80, 3) and m.faces.dtype == torch.int64
    again = tdec.make_random_flame_like_rig(torch.Generator().manual_seed(3), n_verts=40)
    assert torch.equal(again.lbs_model.shapedirs, m.shapedirs)
    v, _ = tdec.flame_forward(rig, *(torch.zeros((1, n)) for n in (100, 50, 6, 3)))
    np.testing.assert_allclose(v[0].numpy(), m.v_template.numpy(), atol=1e-6)


# ---------------------------------------------------------------- gs_flame

def _flame_states(seed=6, splats=2, enlargement=2.0):
    """The same randomized gs_flame state in both packages, with nonzero
    FLAME params so that every decoder term is live."""
    jr, tr = head_rigs(seed)
    jmodel, tmodel = JFlameModel(jr), FlameGaussianModel(tr)
    f = int(jr.lbs_model.faces.shape[0])
    rng = np.random.default_rng(seed)
    alpha = rng.standard_normal((f, splats, 3)).astype(np.float32)
    colors = rng.random((f * splats, 3)).astype(np.float32)
    jstate = jmodel.init_from_flame(jnp.asarray(alpha), jnp.asarray(colors), sh_degree=SH,
                                    vertices_enlargement_init=enlargement)
    p = dict(jstate["params"])
    for k, s in (("flame_shape", 0.1), ("flame_exp", 0.1), ("flame_pose", 0.1),
                 ("flame_neck_pose", 0.1), ("flame_trans", 0.05)):
        p[k] = jnp.asarray((rng.standard_normal(p[k].shape) * s).astype(np.float32))
    p["opacity"] = jnp.asarray((rng.standard_normal(p["opacity"].shape) + 1.0).astype(np.float32))
    p["f_rest"] = jnp.asarray((rng.standard_normal(p["f_rest"].shape) * 0.1).astype(np.float32))
    jstate = {**jstate, "params": p}
    return jmodel, tmodel, jstate, state_from_numpy("gs_flame", tree_np(jstate), device="cpu")


def test_flame_model_holds_the_rig_as_buffers():
    _, tmodel, _, tstate = _flame_states()
    names = dict(tmodel.named_buffers())
    assert {"v_template", "shapedirs", "posedirs", "faces", "lbs_weights"} <= set(names)
    assert tmodel.rig.parents == tdec.FLAME_PARENTS
    assert tstate["consts"]["faces"].dtype == torch.int64
    assert set(tstate["params"]) == {*FLAME_PARAMS, "alpha", "scale", "f_dc", "f_rest", "opacity"}
    state = tmodel.init_from_flame(torch.rand((80, 3, 3)), torch.rand((240, 3)), sh_degree=0)
    assert state["params"]["vertices_enlargement"].shape == (42, 3)
    assert float(state["params"]["vertices_enlargement"][0, 0]) == pytest.approx(8.35)


def test_flame_to_bag_matches_jax():
    jmodel, tmodel, jstate, tstate = _flame_states()
    jbag, tbag = jmodel.to_bag(jstate), tmodel.to_bag(tstate)
    for name in ("xyz", "scaling", "rotation", "opacity", "shs"):
        _rel_close(getattr(tbag, name), getattr(jbag, name), msg=name)
    _rel_close(tmodel.decode_vertices(tstate["params"]), jmodel.decode_vertices(jstate["params"]))
    # the alpha is a softmax over the barycentric axis
    np.testing.assert_allclose(
        tbag.xyz.numpy().reshape(-1, 2, 3)[0, 0],
        (torch.softmax(tstate["params"]["alpha"][0, 0], 0)[:, None]
         * tmodel.decode_vertices(tstate["params"])[tstate["consts"]["faces"][0]]).sum(0).numpy(),
        atol=1e-6)


def test_flame_render_gradients_reach_every_param_and_match_jax():
    jmodel, tmodel, jstate, tstate = _flame_states()
    jc = jax_camera(0.5, dist=4.0, w=32, h=32)
    rng = np.random.default_rng(8)
    gt = rng.random((32, 32, 3)).astype(np.float32)

    def j_loss_fn(params):
        bag = jmodel.to_bag({**jstate, "params": params})
        out = j_render(bag, jc, jnp.ones(3), sh_degree=SH, backend="reference")
        return j_loss.photometric_loss(out.image, jnp.asarray(gt), 0.2)[0]

    j_grads = jax.jit(jax.grad(j_loss_fn))(jstate["params"])
    ts = make_train_state(tstate, optimization_config("gs_flame"))
    out = t_render(tmodel.to_bag(ts.model_state()), to_torch_camera(jc), torch.ones(3),
                   sh_degree=SH)
    photometric_loss(out.image, torch.tensor(gt), 0.2)[0].backward()
    for k, g in j_grads.items():
        g = np.asarray(g)
        t = ts.params[k].grad
        assert torch.isfinite(t).all() and np.abs(g).max() > 0, k
        _rel_close(t, g, rtol=5e-4, msg=k)
    assert all(float(ts.params[k].grad.abs().max()) > 0 for k in FLAME_PARAMS)


def test_one_gs_flame_train_step_matches_jax():
    """One step from the same carried-over state (after a first JAX step,
    so that Adam's moments are nonzero): loss, every param's gradient, the
    statistics, and the params within 3 * lr of their group."""
    jmodel, tmodel, jstate, _ = _flame_states(seed=7)
    jc = jax_camera(0.5, dist=4.0, w=32, h=32)
    teacher = _flame_states(seed=9)[2]
    bg = jnp.ones(3)
    gt = j_render(jmodel.to_bag({**teacher, "consts": jstate["consts"]}), jc, bg, sh_degree=SH,
                  backend="reference").image
    cfg = j_optimization_config("gs_flame")
    ts, tx = j_make_train_state("gs_flame", jstate, cfg)
    j_step = j_make_train_step(jmodel, tx, cfg, SH, backend="reference")
    ts, _ = j_step(ts, jc, gt, bg)
    ts = ts.replace(active_sh_degree=jnp.asarray(1, jnp.int32))

    def j_loss_fn(params):
        bag = jmodel.to_bag({"params": params, "consts": ts.consts, "alive": ts.alive})
        out = j_render(bag, jc, bg, sh_degree=SH, backend="reference")
        return j_loss.photometric_loss(out.image, gt, cfg.lambda_dssim)[0]

    j_grads = jax.jit(jax.grad(j_loss_fn))(ts.params)
    state = train_state_from_numpy("gs_flame", train_state_numpy(ts),
                                   optimization_config("gs_flame"), device="cpu")
    ts2, j_metrics = j_step(ts, jc, gt, bg)
    step = make_train_step(tmodel, optimization_config("gs_flame"), SH)
    state, metrics = step(state, to_torch_camera(jc), torch.tensor(np.asarray(gt)), torch.ones(3))
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
    assert state.step == int(ts2.step) == 2
    for k, g in j_grads.items():
        assert np.abs(np.asarray(g)).max() > 0, k
        _rel_close(state.params[k].grad, g, rtol=5e-4, msg=k)
    lrs = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    for k, v in ts2.params.items():
        diff = np.abs(state.params[k].detach().numpy() - np.asarray(v)).max()
        assert diff <= 3 * lrs[k], (k, diff, lrs[k])
    np.testing.assert_array_equal(state.stats.denom.numpy(), np.asarray(ts2.stats.denom))
    np.testing.assert_array_equal(state.stats.max_radii.numpy(), np.asarray(ts2.stats.max_radii))


# ---------------------------------------------------------------- the reader

def write_blender_dataset(root, n_cams=2, size=24, radius=1.2):
    """A Blender dataset: a ring of cameras around the origin, seeded images."""
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n_cams):
            angle = 2 * np.pi * (i + (0.5 if split == "test" else 0.0)) / n_cams
            c = np.array([radius * np.sin(angle), 0.2, radius * np.cos(angle)])
            fwd = -c / np.linalg.norm(c)
            right = np.cross([0.0, 1.0, 0.0], fwd)
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, :3] = np.stack([right, np.cross(fwd, right), -fwd], axis=1)
            c2w[:3, 3] = c
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
            img = (rng.random((size, size, 4)) * 255).astype(np.uint8)
            Image.fromarray(img, "RGBA").save(os.path.join(root, split, f"r_{i}.png"))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    return root


def test_blender_flame_reader_matches_jax(tmp_path):
    jr, tr = both_rigs(n_verts=48, seed=10)
    roots = [write_blender_dataset(str(tmp_path / n)) for n in ("jax_scene", "port_scene")]
    ref = j_readers.read_nerf_synthetic_flame_info(roots[0], True, True, jr)
    got = t_readers.read_nerf_synthetic_flame_info(roots[1], True, True, tr)
    pr, pg = ref.point_cloud, got.point_cloud
    assert pg.alpha.shape == (96, 100, 3)  # 100 splats per face by default
    np.testing.assert_array_equal(pg.alpha, pr.alpha)
    np.testing.assert_array_equal(pg.colors, pr.colors)
    np.testing.assert_array_equal(pg.faces, np.asarray(pr.faces))
    np.testing.assert_allclose(pg.vertices_init, pr.vertices_init, rtol=0,
                               atol=1e-5 * float(np.abs(pr.vertices_init).max()))
    np.testing.assert_allclose(pg.points, pr.points, rtol=0,
                               atol=1e-5 * float(np.abs(pr.points).max()))
    assert pg.vertices_enlargement_init == pr.vertices_enlargement_init == 8.35
    assert len(got.train_cameras) == len(ref.train_cameras) == 2
    assert got.nerf_normalization["radius"] == ref.nerf_normalization["radius"]
    # and the two Scenes build the same initial state
    jstate = JScene(roots[0], "gs_flame", eval=True, flame_rig=jr,
                    shuffle=False).init_model_state(JFlameModel(jr), sh_degree=SH)
    scene = Scene(roots[1], "gs_flame", eval=True, flame_rig=tr, shuffle=False, device="cpu")
    state = scene.init_model_state(FlameGaussianModel(tr), sh_degree=SH)
    for k, v in jstate["params"].items():
        np.testing.assert_allclose(state["params"][k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="FLAME rig"):
        Scene(roots[1], "gs_flame", device="cpu")
