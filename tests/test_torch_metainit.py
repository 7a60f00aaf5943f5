"""Port parity: the meta-init warm start (training/metainit.py).

`resolve_auto_init` must take the JAX package's warm/cold decision with the
same reason string and, when warm, load the same weights, over the
committed artifacts of assets/meta and over directories made here.
"""
import numpy as np
import pytest

from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.training import metainit as jmeta
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.training import metainit as tmeta

FLAGSHIP = dict(depth=8, hidden_size=96, split_depth=5)


def _both(model, arch, steps, precision, meta_dir=None):
    _, jc = jbuild(model, **arch)
    _, tc = build_model(model, **arch)
    j = jmeta.resolve_auto_init(model, jc, steps, meta_dir=meta_dir, matmul_precision=precision)
    t = tmeta.resolve_auto_init(model, tc, steps, meta_dir=meta_dir, matmul_precision=precision)
    return j, t


def _same(j, t):
    (jp, jpath, jwhy), (tp, tpath, twhy) = j, t
    assert twhy == jwhy
    assert tpath == jpath
    assert (tp is None) == (jp is None)
    if tp is not None:
        assert len(tp) == len(jp)
        for a, b in zip(tp, jp):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_constants_and_store():
    assert tmeta.WARM_BUDGET_MAX_STEPS == jmeta.WARM_BUDGET_MAX_STEPS == 3000
    assert tmeta.default_meta_dir() == jmeta.default_meta_dir()
    for p in sorted(tmeta.default_meta_dir().glob("*.npz")):
        assert tmeta.meta_precision(p) == jmeta.meta_precision(p)


@pytest.mark.parametrize("precision,steps,want", [
    ("tensorfloat32", 1200, "coordx_s5w96_512_tf32.npz"),  # the flagship's artifact
    ("tensorfloat32", 3000, "coordx_s5w96_512_tf32.npz"),  # the budget limit itself
    (None, 1200, "coordx_s5w96_512.npz"),  # the artifact without a precision field
    ("bfloat16", 1200, None),  # precision mismatch: every artifact rejected
    ("tensorfloat32", 3001, None),  # past the measured warm-win budget
])
def test_flagship_decision_matches_jax(precision, steps, want):
    j, t = _both("coordx", FLAGSHIP, steps, precision)
    _same(j, t)
    assert (t[1].name if t[1] is not None else None) == want


def test_architecture_mismatch_matches_jax():
    j, t = _both("coordx", dict(FLAGSHIP, hidden_size=64), 1200, "tensorfloat32")
    _same(j, t)
    assert t[0] is None and "architecture mismatch" in t[2]


def test_siren_default_decision_matches_jax():
    _same(*_both("siren", dict(depth=8, hidden_size=128), 2000, "tensorfloat32"))


def test_empty_and_missing_store_match_jax(tmp_path):
    j, t = _both("coordx", FLAGSHIP, 1200, "tensorfloat32", meta_dir=tmp_path)
    _same(j, t)
    assert t[2].endswith("(empty)")
    j, t = _both("coordx", FLAGSHIP, 1200, "tensorfloat32", meta_dir=tmp_path / "none")
    _same(j, t)
    assert t[2].startswith("no artifact store")


@pytest.mark.parametrize("name,mlp,masking", [
    ("wavelet_siren", {"name": "wavelet_siren"}, {}),
    ("fourier", {"name": "fourier"}, {}),
    ("feather_siren", {"name": "siren"}, {"name": "Feathermap", "dense": True, "density": 0.2}),
])
def test_other_families_cold_start_as_jax(name, mlp, masking):
    """train.init_path=auto for the reference's other families: assets/meta
    holds no artifact of theirs, so both packages cold-start, for the same
    reasons."""
    from implicit_image_tpu.models import build_model_from_config as jbuild_cfg
    from implicit_image_tpu_torch.models import build_model_from_config as tbuild_cfg

    cfg = {"mlp": mlp, "masking": masking}
    (jm, jc), (tm, tc) = jbuild_cfg(cfg), tbuild_cfg(cfg)
    assert jm.name == tm.name == name
    j = jmeta.resolve_auto_init(jm.name, jc, 2000, matmul_precision="tensorfloat32")
    t = tmeta.resolve_auto_init(tm.name, tc, 2000, matmul_precision="tensorfloat32")
    _same(j, t)
    assert t[0] is None and "no matching artifact" in t[2]
