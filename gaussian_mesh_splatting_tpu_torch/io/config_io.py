"""Training-config persistence (a copy of
`gaussian_mesh_splatting_tpu/io/config_io.py`).

The reference writes `str(Namespace(...))` to `{model}/cfg_args` and
re-hydrates it with `eval()` at render/metrics time
(train.py:171-172, arguments/__init__.py:93-113). We keep the persistence
contract (same filename, CLI-overrides-file merge) but store JSON — the
`eval()` is an injection hazard documented in SURVEY.md §7 as a quirk not
to replicate."""
from __future__ import annotations

import json
import os
from typing import Any


def save_cfg(model_path: str, cfg: dict[str, Any]) -> None:
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)


def load_cfg(model_path: str) -> dict[str, Any]:
    path = os.path.join(model_path, "cfg_args")
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("{"):
        return json.loads(text)
    # tolerate reference-written Namespace(...) files WITHOUT eval: parse
    # the k=v list with a literal-only parser
    import ast

    if not (text.startswith("Namespace(") and text.endswith(")")):
        raise ValueError(f"{path}: neither JSON nor a Namespace(...) dump")
    inner = "dict(" + text[len("Namespace(") : -1] + ")"
    node = ast.parse(inner, mode="eval")
    out = {}
    for kw in node.body.keywords:
        out[kw.arg] = ast.literal_eval(kw.value)
    return out


def combined_args(model_path: str, cli: dict[str, Any]) -> dict[str, Any]:
    """File config with CLI overrides taking precedence when not None
    (arguments/__init__.py:109-113)."""
    try:
        merged = load_cfg(model_path)
    except FileNotFoundError:
        merged = {}
    for k, v in cli.items():
        if v is not None:
            merged[k] = v
    return merged
