"""Config system — a Hydra-shaped composer without the Hydra dependency.

The reference composes its run config from a YAML group tree with Hydra 1.x
(conf/config.yaml defaults list, `+group=option` / `group.key=value` CLI
overrides, `${...}` interpolation, `-m` multirun over comma lists —
reference README.md:70-100, Makefile:5-6). Hydra/OmegaConf are not in this
environment, so the same UX is implemented directly:

  * `compose(overrides)` — load conf/config.yaml, resolve its defaults
    list into config groups, apply overrides, resolve `${a.b}`
    interpolation, return an attribute-accessible DotDict
  * group override     `masking=RigL`  (also `+masking=RigL` — Hydra's
    append syntax is accepted and treated identically)
  * value override     `mlp.hidden_size=256` (YAML-parsed scalars)
  * deletion           `~quant` (Hydra's delete syntax)
  * `expand_multirun(overrides)` — the cartesian product of comma lists,
    Hydra `-m` semantics (each element is one job's override list)

The group tree lives in implicit_image_tpu_torch/config/conf/ and mirrors the
reference's conf/ groups: img/ mlp/ optim/ masking/ quant/ entropy_coding/.

This module and its tree are the port's own copy of implicit_image_tpu/config
(which imports no framework either), so the port never imports the JAX
package; tests/test_torch_config.py holds the two composers equal.
"""
from __future__ import annotations

import copy
import itertools
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import yaml

__all__ = ["DotDict", "compose", "expand_multirun", "CONF_DIR", "to_dict"]

CONF_DIR = Path(__file__).parent / "conf"

GROUPS = ("img", "mlp", "optim", "masking", "quant", "entropy_coding")


class DotDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def get(self, k, default=None):
        return super().get(k, default)


def _wrap(obj):
    if isinstance(obj, dict):
        return DotDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def to_dict(obj):
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_dict(v) for v in obj]
    return obj


def _load_yaml(path: Path) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    data.pop("# @package", None)
    return data


def _load_group(group: str, option: str) -> dict:
    path = CONF_DIR / group / f"{option}.yaml"
    if not path.exists():
        available = sorted(p.stem for p in (CONF_DIR / group).glob("*.yaml"))
        raise KeyError(
            f"Config group {group!r} has no option {option!r}; available: {available}"
        )
    return _load_yaml(path)


def _set_dotted(cfg: dict, dotted: str, value):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def _get_dotted(cfg: dict, dotted: str):
    node = cfg
    for p in dotted.split("."):
        node = node[p]
    return node


_INTERP = re.compile(r"\$\{([^}]+)\}")


def _resolve_interp(cfg: dict):
    """Resolve ${a.b} references (iteratively, Hydra-style)."""

    def resolve_value(v, depth=0):
        if depth > 10:
            raise ValueError(f"Interpolation loop at {v!r}")
        if isinstance(v, str):
            full = _INTERP.fullmatch(v.strip())
            if full:
                try:
                    tgt = _get_dotted(cfg, full.group(1))
                except KeyError:
                    return v
                return resolve_value(tgt, depth + 1)

            def sub(m):
                try:
                    tgt = _get_dotted(cfg, m.group(1))
                except KeyError:
                    return m.group(0)
                return str(resolve_value(tgt, depth + 1))

            return _INTERP.sub(sub, v)
        return v

    def walk(node):
        for k, v in list(node.items()):
            if isinstance(v, dict):
                walk(v)
            else:
                node[k] = resolve_value(v)

    for _ in range(4):  # a few passes for chained refs
        walk(cfg)


def compose(
    overrides: Optional[Sequence[str]] = None,
    config_name: str = "config",
) -> DotDict:
    """Compose the run config: defaults tree + overrides + interpolation."""
    overrides = list(overrides or [])
    root = _load_yaml(CONF_DIR / f"{config_name}.yaml")
    defaults = root.pop("defaults", [])

    # split overrides into group selections vs value overrides vs deletions
    group_sel: Dict[str, Optional[str]] = {}
    value_overrides: List[Tuple[str, Any]] = []
    for ov in overrides:
        if ov.startswith("~"):
            group_sel[ov[1:]] = None
            continue
        if "=" not in ov:
            raise ValueError(f"Malformed override {ov!r} (expected key=value)")
        key, val = ov.split("=", 1)
        key = key.lstrip("+")
        if key in GROUPS:
            group_sel[key] = val
        else:
            value_overrides.append((key, yaml.safe_load(val)))

    cfg: dict = {}
    for entry in defaults:
        if isinstance(entry, dict):
            (group, option), = entry.items()
            if group in group_sel:
                option = group_sel.pop(group)
                if option is None:
                    continue
            cfg[group] = _load_group(group, str(option))
        # bare entries (hydra plumbing in the reference) are ignored
    # groups selected on the CLI that aren't in defaults (Hydra's +group=)
    for group, option in group_sel.items():
        if option is not None:
            cfg[group] = _load_group(group, option)

    for k, v in root.items():
        cfg[k] = copy.deepcopy(v)

    for key, val in value_overrides:
        _set_dotted(cfg, key, val)

    _resolve_interp(cfg)
    return _wrap(cfg)


def expand_multirun(overrides: Sequence[str]) -> List[List[str]]:
    """Hydra -m semantics: cartesian product of comma-separated values."""
    axes: List[List[str]] = []
    for ov in overrides:
        if "=" in ov and "," in ov.split("=", 1)[1]:
            key, vals = ov.split("=", 1)
            axes.append([f"{key}={v}" for v in vals.split(",")])
        else:
            axes.append([ov])
    return [list(combo) for combo in itertools.product(*axes)]
