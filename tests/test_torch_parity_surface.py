"""The port's public surface against the JAX package's, read from the
sources with `ast` (neither package is imported):

  (a) every module of `gaussian_mesh_splatting_tpu/` has a counterpart
      module in `gaussian_mesh_splatting_tpu_torch/` (`rasterize_pallas` ->
      `rasterize_cuda`);
  (b) every public top-level function or class of a module, and every name
      a package's `__init__.py` imports from inside the package, has a
      same-named counterpart in the counterpart module (a def, a class, an
      import or an assignment);
  (c) every public function both modules define takes at least the JAX
      function's parameter names;
  (d) every root script of the JAX package (`tools_*.py` that is not
      `tools_torch_*`, `profile_*.py`, `bench.py`) has a counterpart.

What the port does not carry over is listed in ALLOWED, one entry a gap,
each with its reason; an entry that no longer matches a gap fails too, so
the list stays what the port lacks. A synthetic pair of module trees shows
that the checker reports a missing module, name, parameter and tool."""
from __future__ import annotations

import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "gaussian_mesh_splatting_tpu")
PORT_PKG = os.path.join(ROOT, "gaussian_mesh_splatting_tpu_torch")

MODULE_RENAMES = {"ops/rasterize_pallas.py": "ops/rasterize_cuda.py"}
NAME_RENAMES = {  # (JAX module, JAX name) -> the port's name in the counterpart module
    ("ops/rasterize_pallas.py", "rasterize_pallas"): "rasterize_cuda",
    ("utils/profiling.py", "xprof_trace"): "profiler_trace",
    ("utils/__init__.py", "xprof_trace"): "profiler_trace",
}
TOOL_RENAMES = {  # JAX root script -> its counterpart, a path in the repo
    "tools_verify_scale.py": "tools_torch_full_run.py",
    "tools_verify_sharded_tpu.py": "tools_torch_multicard.py",
    "bench.py": "gaussian_mesh_splatting_tpu_torch/bench.py",
}

PALLAS_LAYOUT = ("the Pallas kernel's chunk-padded pair layout; the port bins exactly, held "
                 "equal in tests/test_torch_binning.py")
ROW_BAND = "row_band=(lo, hi): the port bins global tiles clipped to a band of tile rows"
OPTAX = "optax transformation: the port's optimizer is a torch.optim.Adam in the TrainState"
JAX_KEY = "a jax.random key: the port draws from a torch.Generator"
PALLAS_INTERPRET = "Pallas interpret mode: the port's CPU path is each kernel's plain version"
PYTREE_BATCH = ("JAX pytree batching of cameras for shard_map: a port rank takes its own "
                "cameras")
GS_TYPE_GROUPS = "the port's Adam groups come from the param keys, not from the gs_type"
GUI_GLOBALS = ("module-level socket state: the port's apps/network_gui.NetworkGUI object owns "
               "its sockets and has these as methods")
TPU_PROFILES = ("TPU xprof and phase profiles: the port's on-card timings are chip_smoke.py "
                "phase 6, tools_torch_step_timing.py and tools_torch_composite_probe.py")
PROFILE_SCRIPTS = ("profile_bin.py", "profile_bin3.py", "profile_bwd.py", "profile_c256.py",
                   "profile_full.py", "profile_ops.py", "profile_r2.py", "profile_r3.py",
                   "profile_r4.py", "profile_r4b.py", "profile_r5.py", "profile_sort.py",
                   "profile_step.py", "profile_xprof.py")

ALLOWED = {
    ("name", "ops/binning.py", "AlignedBinning"): PALLAS_LAYOUT,
    ("name", "ops/binning.py", "build_aligned_binning"): PALLAS_LAYOUT,
    ("name", "ops/rasterize_pallas.py", "default_pair_capacity"): PALLAS_LAYOUT,
    ("param", "ops/binning.py", "tile_rect", "row_tile_offset"): ROW_BAND,
    ("param", "ops/rasterize_pallas.py", "rasterize_pallas", "num_row_tiles"): ROW_BAND,
    ("param", "ops/rasterize_pallas.py", "rasterize_pallas", "row_tile_offset"): ROW_BAND,
    ("param", "ops/rasterize_pallas.py", "rasterize_pallas", "chunk"): PALLAS_LAYOUT,
    ("param", "ops/rasterize_pallas.py", "rasterize_pallas", "interpret"): PALLAS_INTERPRET,
    ("param", "parallel/row_sharded.py", "render_row_sharded", "interpret"): PALLAS_INTERPRET,
    ("param", "parallel/gaussian_sharded.py", "render_gaussian_sharded",
     "interpret"): PALLAS_INTERPRET,
    ("name", "core/camera.py", "stack_cameras"): PYTREE_BATCH,
    ("name", "core/camera.py", "take_camera"): PYTREE_BATCH,
    ("name", "core/__init__.py", "stack_cameras"): PYTREE_BATCH,
    ("name", "core/__init__.py", "take_camera"): PYTREE_BATCH,
    ("name", "ops/lpips.py", "make_lpips_fn"): "a jax.jit closure over the weights: the port "
                                               "calls ops.lpips.lpips with its params",
    ("name", "ops/lpips.py", "convert_torch_checkpoint"): "downloads the pretrained weights: "
                                                          "waits for the file, ROADMAP section A",
    ("param", "ops/lpips.py", "synthetic_params", "key"): JAX_KEY,
    ("param", "train/densify.py", "densify_and_prune", "key"): JAX_KEY,
    ("param", "models/flame/decoder.py", "make_random_flame_like_rig", "key"): JAX_KEY,
    ("param", "train/loop.py", "make_train_step", "tx"): OPTAX,
    ("param", "train/densify.py", "grow_capacity", "tx"): OPTAX,
    ("param", "parallel/data_parallel.py", "make_dp_train_step", "tx"): OPTAX,
    ("param", "parallel/sharded_step.py", "make_sharded_train_step", "tx"): OPTAX,
    ("param", "train/state.py", "make_optimizer", "gs_type"): GS_TYPE_GROUPS,
    ("param", "train/state.py", "make_train_state", "gs_type"): GS_TYPE_GROUPS,
    **{("param", "parallel/multihost.py", "initialize", p): (
        "jax.distributed's coordinator: the port joins with init_method, world_size and rank "
        "or the torchrun environment")
       for p in ("coordinator_address", "num_processes", "process_id")},
    ("param", "apps/train.py", "dump_debug_state", "tstate"): (
        "the port dumps a StepInputs copy made before the in-place step (ROADMAP C1)"),
    **{("name", "apps/network_gui.py", n): GUI_GLOBALS
       for n in ("init", "try_connect", "receive", "send", "disconnect")},
    ("tool", "tools_assemble_verify_r5.py"): ("assembles VERIFY_r5.json from the JAX tools' "
                                              "outputs: the port's tools write their JSON "
                                              "themselves"),
    **{("tool", name): TPU_PROFILES for name in PROFILE_SCRIPTS},
    **{("name", m, "StepTimer"): ("a host-clock EMA step timer that nothing read: the "
                                  "port's step and stage times are the tracer's spans "
                                  "(utils/profiling.Recording) and the train step's mark "
                                  "hook") for m in ("utils/profiling.py", "utils/__init__.py")},
}


def module_surface(path: str) -> tuple[dict, set]:
    """({public top-level def or class: its parameter names, None for a
    class}, {names bound at top level by imports and assignments}) of a
    module; in a package's `__init__.py` the names imported from inside the
    package (relative imports) also count as its public surface."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    defs, bound = {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            params = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
            params += [f"*{a.vararg.arg}"] if a.vararg else []
            params += [f"**{a.kwarg.arg}"] if a.kwarg else []
            defs[node.name] = params
        elif isinstance(node, ast.ClassDef):
            defs[node.name] = None
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = (alias.asname or alias.name).split(".")[0]
                bound.add(name)
                if (os.path.basename(path) == "__init__.py" and isinstance(node, ast.ImportFrom)
                        and node.level > 0):
                    defs.setdefault(name, "export")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            bound.update(t.id for t in targets if isinstance(t, ast.Name))
    public = {k: v for k, v in defs.items() if not k.startswith("_")}
    return public, bound | set(defs)


def surface_gaps(jax_pkg: str, port_pkg: str, module_renames: dict, name_renames: dict
                 ) -> set:
    """Checks (a)-(c): the set of ("module", rel), ("name", rel, name) and
    ("param", rel, name, param) gaps, `rel` the JAX module's path in its
    package."""
    gaps = set()
    for dirpath, _, files in os.walk(jax_pkg):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), jax_pkg).replace(os.sep, "/")
            port_path = os.path.join(port_pkg, module_renames.get(rel, rel))
            if not os.path.exists(port_path):
                gaps.add(("module", rel))
                continue
            jax_defs, _ = module_surface(os.path.join(jax_pkg, rel))
            port_defs, port_names = module_surface(port_path)
            for name, params in jax_defs.items():
                port_name = name_renames.get((rel, name), name)
                if port_name not in port_names:
                    gaps.add(("name", rel, name))
                elif isinstance(params, list) and isinstance(port_defs.get(port_name), list):
                    gaps.update(("param", rel, name, p) for p in params
                                if p not in port_defs[port_name])
    return gaps


def tool_gaps(repo: str, tool_renames: dict) -> set:
    """Check (d): ("tool", script) for every JAX root script without its
    counterpart (`tools_X.py` -> `tools_torch_X.py` unless renamed)."""
    gaps = set()
    for fname in os.listdir(repo):
        jax_script = fname.endswith(".py") and (
            (fname.startswith("tools_") and not fname.startswith("tools_torch_"))
            or fname.startswith("profile_") or fname == "bench.py")
        if not jax_script:
            continue
        port = tool_renames.get(fname, "tools_torch_" + fname[len("tools_"):])
        if not os.path.exists(os.path.join(repo, port)):
            gaps.add(("tool", fname))
    return gaps


def repo_gaps() -> set:
    return (surface_gaps(JAX_PKG, PORT_PKG, MODULE_RENAMES, NAME_RENAMES)
            | tool_gaps(ROOT, TOOL_RENAMES))


def test_every_gap_is_allowed_with_a_reason():
    gaps = repo_gaps()
    unexplained = sorted(gaps - set(ALLOWED))
    assert not unexplained, f"the port lacks these counterparts: {unexplained}"


def test_every_allowed_entry_is_still_a_gap():
    stale = sorted(set(ALLOWED) - repo_gaps())
    assert not stale, f"these allow-list entries name no gap any more: {stale}"


def test_every_reason_is_one_line():
    for key, reason in ALLOWED.items():
        assert reason.strip() and "\n" not in reason, key


def test_renames_name_existing_counterparts():
    for (rel, _), port_name in NAME_RENAMES.items():
        port_rel = MODULE_RENAMES.get(rel, rel)
        _, names = module_surface(os.path.join(PORT_PKG, port_rel))
        assert port_name in names, (rel, port_name)
    for port in TOOL_RENAMES.values():
        assert os.path.exists(os.path.join(ROOT, port)), port


def _write(path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def test_checker_reports_missing_module_name_param_and_tool(tmp_path):
    jax_pkg, port_pkg = tmp_path / "jax_pkg", tmp_path / "port_pkg"
    _write(jax_pkg / "__init__.py", "from .a import f, C\n")
    _write(jax_pkg / "a.py", "import numpy as np\n\n\ndef f(x, y, *, z=1):\n    pass\n\n\n"
                             "class C:\n    pass\n\n\ndef _private(q):\n    pass\n")
    _write(jax_pkg / "sub" / "b.py", "def g(t):\n    pass\n")
    _write(jax_pkg / "sub" / "old.py", "def h():\n    pass\n")
    _write(port_pkg / "__init__.py", "from .a import f\n")
    _write(port_pkg / "a.py", "import torch\n\n\ndef f(x, z=1):\n    pass\n")
    _write(port_pkg / "sub" / "b.py", "from .c import g\n")
    got = surface_gaps(str(jax_pkg), str(port_pkg), {}, {})
    assert got == {("param", "a.py", "f", "y"), ("name", "a.py", "C"),
                   ("name", "__init__.py", "C"), ("module", "sub/old.py")}
    # a counterpart makes each gap go away; a rename names the port's module
    _write(port_pkg / "a.py", "def f(x, y, z=1, extra=None):\n    pass\n\n\nclass C:\n"
                              "    pass\n")
    _write(port_pkg / "__init__.py", "from .a import f, C\n")
    _write(port_pkg / "sub" / "new.py", "def h():\n    pass\n")
    assert surface_gaps(str(jax_pkg), str(port_pkg), {"sub/old.py": "sub/new.py"}, {}) == set()

    repo = tmp_path / "repo"
    for name in ("tools_alpha.py", "tools_beta.py", "tools_torch_alpha.py", "profile_x.py",
                 "bench.py", "port_bench.py"):
        _write(repo / name, "")
    assert tool_gaps(str(repo), {"bench.py": "port_bench.py"}) == {
        ("tool", "tools_beta.py"), ("tool", "profile_x.py")}
