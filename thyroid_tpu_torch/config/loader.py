"""YAML config composition with command-line overrides (counterpart of
thyroid_tpu/config/loader.py, the same rules).

Hydra's semantics without Hydra:
- a root YAML may carry `defaults: [{group: option}, ...]`; each entry
  loads `<config_dir>/<group>/<option>.yaml` and sets it under key
  `<group>` (its own `defaults` list dropped); `option` may hold `/`
  subdirectories (`model: cnn/efficientnet_b0`);
- `_self_` entries, null options and bare strings (a file merged at the
  top level) are accepted in the defaults list;
- overrides: `group=option` re-selects a config group; `a.b.c=value` sets
  a dotted path; `+a.b=value` adds; `~a.b` deletes. Values are parsed by
  `yaml.safe_load`.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Iterable, Sequence

import yaml

from .node import ConfigNode

DEFAULT_CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"

# Config groups that exist as directories; an override `model=cnn/resnet18`
# re-resolves the group file rather than assigning the string.
_GROUP_KEYS = (
    "model", "dataset", "training", "trainer", "kfold", "params",
    "augmentation", "experiment", "student_model",
)


def _read_yaml(path: Path) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def _resolve_group_file(config_dir: Path, group: str, option: str) -> Path:
    # student_model reuses the model group tree.
    dir_group = "model" if group == "student_model" else group
    path = config_dir / dir_group / f"{option}.yaml"
    if not path.exists():
        raise FileNotFoundError(
            f"config group '{group}' has no option '{option}' "
            f"(looked for {path})"
        )
    return path


def _load_group(config_dir: Path, group: str, option: str) -> ConfigNode:
    node = ConfigNode(_read_yaml(_resolve_group_file(config_dir, group, option)))
    node.pop("defaults", None)
    # Remember which option produced this node (useful for sweeps/logging).
    node.setdefault("config_name", option)
    return node


def _parse_value(text: str) -> Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def compose(
    config_name: str = "config",
    overrides: Sequence[str] = (),
    config_dir: str | os.PathLike | None = None,
) -> ConfigNode:
    """Compose the root config with defaults + overrides (Hydra-like)."""
    cdir = Path(config_dir) if config_dir is not None else DEFAULT_CONFIG_DIR
    root_raw = _read_yaml(cdir / f"{config_name}.yaml")
    defaults: Iterable[Any] = root_raw.pop("defaults", [])
    cfg = ConfigNode()

    # Pre-scan overrides for group re-selections so defaults pick them up.
    group_over: dict[str, str] = {}
    path_over: list[tuple[str, str, Any]] = []  # (op, path, value)
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            path_over.append(("del", ov[1:], None))
            continue
        add = ov.startswith("+")
        if add:
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"override '{ov}' must look like key=value or ~key")
        key, _, raw = ov.partition("=")
        key = key.strip()
        if key in _GROUP_KEYS and "." not in key:
            group_over[key] = raw.strip()
        else:
            path_over.append(("add" if add else "set", key, _parse_value(raw)))

    seen_groups: set[str] = set()
    for entry in defaults:
        if entry == "_self_" or entry is None:
            continue
        if isinstance(entry, str):
            # bare include: merge file at top level
            cfg.merge(_read_yaml(cdir / f"{entry}.yaml"))
            continue
        (group, option), = entry.items()
        if option is None:
            continue
        option = group_over.get(group, option)
        cfg[group] = _load_group(cdir, group, str(option))
        seen_groups.add(group)

    # Group overrides not present in defaults (e.g. experiment=...)
    for group, option in group_over.items():
        if group not in seen_groups:
            cfg[group] = _load_group(cdir, group, option)

    # Root file's own (non-defaults) content merges on top of group defaults.
    cfg.merge(root_raw)

    for op, path, value in path_over:
        if op == "del":
            parent_path, _, leaf = path.rpartition(".")
            parent = cfg.select(parent_path) if parent_path else cfg
            parent.pop(leaf, None)
        else:
            cfg.update_path(path, value)
    return cfg


def load_model_config(name: str, config_dir: str | os.PathLike | None = None) -> ConfigNode:
    """Load a single model YAML by `family/name` or bare `name`."""
    cdir = Path(config_dir) if config_dir is not None else DEFAULT_CONFIG_DIR
    if "/" in name:
        return _load_group(cdir, "model", name)
    for family in ("cnn", "vit", "ensemble"):
        path = cdir / "model" / family / f"{name}.yaml"
        if path.exists():
            return _load_group(cdir, "model", f"{family}/{name}")
    raise FileNotFoundError(f"no model config named '{name}' under {cdir / 'model'}")


def list_model_configs(config_dir: str | os.PathLike | None = None,
                       families: Sequence[str] = ("cnn", "vit")) -> list[str]:
    """All `family/name` model options, excluding `*base*` template files.

    Mirrors the discovery rule of the reference all-models sweep
    (reference: src/experiment/all_models_full_kfold_experiment.py:39-64).
    """
    cdir = Path(config_dir) if config_dir is not None else DEFAULT_CONFIG_DIR
    out: list[str] = []
    for family in families:
        fdir = cdir / "model" / family
        if not fdir.is_dir():
            continue
        for path in sorted(fdir.glob("*.yaml")):
            if "base" == path.stem or path.stem.endswith("_base_cfg"):
                continue
            out.append(f"{family}/{path.stem}")
    return out
