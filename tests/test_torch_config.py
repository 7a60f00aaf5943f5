"""Port parity: the port's own config composer and YAML tree
(implicit_image_tpu_torch.config) against the JAX package's
(implicit_image_tpu.config): the same files, and the same composed config
for every override list the port's runs and tests use."""
from pathlib import Path

import pytest

import chip_smoke
from implicit_image_tpu import config as jconfig
from implicit_image_tpu_torch import config as tconfig
from test_torch_compress import OVERRIDES as COMPRESS_OVERRIDES

_LISTS = {
    "none": [],
    "smoke": chip_smoke.SMOKE_OVERRIDES,
    "default": chip_smoke.DEFAULT_OVERRIDES,
    **{
        f"preset_{p}": chip_smoke.PRESET_OVERRIDES
        + [f"masking={p}", f"output_dir=outputs/chip_smoke_{p.lower()}"]
        for p in chip_smoke.PRESETS
    },
    "test_torch_compress": COMPRESS_OVERRIDES,
}


@pytest.mark.parametrize("name", sorted(_LISTS))
def test_compose_matches_the_jax_package(name):
    ov = list(_LISTS[name])
    ours = tconfig.compose(ov)
    theirs = jconfig.compose(ov)
    assert isinstance(ours, tconfig.DotDict)
    assert tconfig.to_dict(ours) == jconfig.to_dict(theirs)


def _tree(root: Path):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*.yaml"))}


def test_yaml_tree_is_a_copy():
    ours, theirs = _tree(tconfig.CONF_DIR), _tree(jconfig.CONF_DIR)
    assert len(ours) == 29
    assert ours == theirs
