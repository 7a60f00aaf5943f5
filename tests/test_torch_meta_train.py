"""Port parity: REPTILE meta-training (training/metainit.py) and its CLI
(meta_train.py). The pool equals the JAX package's; artifacts load across
packages; the port's meta_step loop, started from JAX's init and fed JAX's
index draws, ends on JAX's meta-params and loss curve (SIREN over the
member axis, CoordX member by member); the CLI's artifact warm-starts a
port compress run; without device=cpu the entry points raise here."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.training import metainit as jmeta
from implicit_image_tpu_torch import meta_train as tmeta_cli
from implicit_image_tpu_torch.compress import compose
from implicit_image_tpu_torch.compress import main as tcompress_main
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.training import metainit as tmeta

torch.set_num_threads(1)

ARCHS = {"siren": dict(depth=3, hidden_size=16), "coordx": dict(depth=4, hidden_size=16,
                                                                  split_depth=2)}


def test_meta_pool_equals_jax():
    for args in ((16, 16, 4), (20, 24, 3, ("alpha",))):
        np.testing.assert_array_equal(tmeta.meta_pool(*args), jmeta.meta_pool(*args))
    assert dataclasses.asdict(tmeta.MetaConfig()) == dataclasses.asdict(jmeta.MetaConfig())


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifacts_load_across_packages(tmp_path, name, writer):
    """An artifact written by either package's save_meta_init loads in the
    other's load_meta_init (and in its own) to equal arrays, with equal
    meta.* and mcfg.* fields."""
    jd, jc = jbuild(name, **ARCHS[name])
    td, tc = build_model(name, **ARCHS[name])
    params = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(3), jc))
    path = tmp_path / f"{writer}.npz"
    if writer == "jax":
        jmeta.save_meta_init(path, params, name, jc, matmul_precision="tensorfloat32")
    else:
        tmeta.save_meta_init(path, params_from_jax(params, "cpu"), name, tc,
                             matmul_precision="tensorfloat32")
    data = np.load(path)
    ref = tmp_path / "ref.npz"
    jmeta.save_meta_init(ref, params, name, jc, matmul_precision="tensorfloat32")
    want = np.load(ref)
    assert sorted(data.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(data[k], want[k])
    assert tmeta.meta_precision(path) == jmeta.meta_precision(path) == "tensorfloat32"
    ours = tmeta.load_meta_init(path, expect_model=name, expect_mcfg=tc)
    theirs = jmeta.load_meta_init(path, expect_model=name, expect_mcfg=jc)
    for a, b, p in zip(ours, theirs, params):
        assert sorted(a) == sorted(b) == sorted(p)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
            np.testing.assert_array_equal(a[k].numpy(), p[k])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_meta_step_loop_matches_jax_meta_train(name):
    """JAX's meta_train (pool 4, batch 2, inner 3, outer 2, chunk 1, 16²)
    against the port's loop of meta_step from JAX's initial params with
    JAX's index draws (the same key splits): the loss curve within 1e-5
    relative and each final meta-param tensor within 1e-4 of its largest
    magnitude (fp32; the port reads <= 6e-6 here)."""
    mc = jmeta.MetaConfig(pool_size=4, meta_batch=2, inner_steps=3, outer_steps=2, chunk=1)
    pool = jmeta.meta_pool(16, 16, mc.pool_size)
    jd, jc = jbuild(name, **ARCHS[name])
    jparams, jlosses, _ = jmeta.meta_train(jd, jc, jgrid(16, 16), pool, mc)
    key = jax.random.PRNGKey(mc.seed)
    key, init_key = jax.random.split(key)
    meta = params_from_jax(jax.tree.map(np.asarray, jd.init(init_key, jc)), "cpu")
    td, tc = build_model(name, **ARCHS[name])
    meta_step = tmeta.make_meta_step(td, tc, get_grid(16, 16), tmeta.MetaConfig(
        **dataclasses.asdict(mc)), "fp32", "cpu")
    flat = pool.reshape(mc.pool_size, 16 * 16, 3)
    losses = []
    for j in range(mc.outer_steps):
        key, skey = jax.random.split(key)
        idx = np.asarray(jax.random.choice(skey, mc.pool_size, shape=(mc.meta_batch,),
                                           replace=False))
        meta, loss = meta_step(meta, flat[idx], j)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-5)
    for a, b in zip(meta, jparams):
        assert sorted(a) == sorted(b)
        for k in a:
            ref = np.asarray(b[k])
            assert np.abs(a[k].numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), k


def test_meta_train_loop_and_validation():
    """meta_train on the CPU: a loss per meta-step, finite, logged once per
    chunk; the JAX package's argument checks."""
    td, tc = build_model("siren", **ARCHS["siren"])
    mc = tmeta.MetaConfig(pool_size=3, meta_batch=2, inner_steps=2, outer_steps=4, chunk=2)
    pool = tmeta.meta_pool(12, 12, 3)
    logged = []
    params, losses, wall = tmeta.meta_train(td, tc, get_grid(12, 12), pool, mc,
                                            log=lambda s, v: logged.append(s), device="cpu")
    assert losses.shape == (4,) and losses.dtype == np.float32 and np.isfinite(losses).all()
    assert logged == [2, 4] and wall >= 0.0
    assert [sorted(layer) for layer in params] == [["b", "w"]] * 3
    for bad, match in ((dict(chunk=3), "must divide"), (dict(meta_batch=4), "exceeds")):
        with pytest.raises(ValueError, match=match):
            tmeta.meta_train(td, tc, get_grid(12, 12), pool, dataclasses.replace(mc, **bad),
                             device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tmeta.meta_train(td, tc, get_grid(8, 8), pool, mc, device="cpu")


def test_cli_artifact_warm_starts_a_compress_run(tmp_path, capsys):
    """The CLI writes an artifact (precision recorded) that a port compress
    run consumes through train.init_path."""
    art = tmp_path / "meta.npz"
    argv = ["device=cpu", "img.height=12", "img.width=12", "mlp.depth=3", "mlp.hidden_size=16",
            "meta.pool_size=3", "meta.meta_batch=2", "meta.inner_steps=2",
            "meta.outer_steps=3", "meta.chunk=2", f"meta.out={art}"]
    assert tmeta_cli.run(compose(argv)) == str(art)
    assert f"META_INIT path={art}" in capsys.readouterr().out
    assert tmeta.meta_precision(art) == "tensorfloat32"
    _, tc = build_model("siren", **ARCHS["siren"])
    assert len(tmeta.load_meta_init(art, expect_model="siren", expect_mcfg=tc)) == 3
    psnr, nbytes = tcompress_main(compose([
        "device=cpu", "img=synthetic", "img.height=12", "img.width=12", "mlp.depth=3",
        "mlp.hidden_size=16", "masking=none", "train.num_steps=4", "train.log_steps=4",
        "quant.num_steps=2", "entropy_coding=plain", f"train.init_path={art}",
        "logging.use=false"]), run_dir=str(tmp_path / "run"))
    assert np.isfinite(psnr) and nbytes > 0


def test_entry_points_raise_without_cuda():
    """Without device=cpu, meta_train and the CLI's run look for the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    td, tc = build_model("siren", **ARCHS["siren"])
    mc = tmeta.MetaConfig(pool_size=2, meta_batch=2, inner_steps=1, outer_steps=1, chunk=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmeta.meta_train(td, tc, get_grid(8, 8), tmeta.meta_pool(8, 8, 2), mc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmeta_cli.run(compose(["img.height=8", "img.width=8", "meta.outer_steps=1"]))
