"""Port parity: checkpoint / resume / watch (training/checkpoint.py, the
fit's boundaries).

  * each package loads the other's checkpoint.npz: params, Adam moments
    and count, masks and their scalars, step (exactly);
  * resuming at step k and running to n gives the same bits as the
    uninterrupted n-step fit (RigL, mask updates on both sides of k), also
    with another train.segment_steps on the resumed run;
  * a JAX checkpoint resumes in the port, and the resumed fit ends within
    the fit parity bound (1e-4 of the largest weight) of the JAX fit;
  * train.watch writes the JAX package's histograms.jsonl rows at every
    boundary (the same tensor names and bins);
  * train.stop_at_psnr with train.resume raises, as in JAX.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu import compress as jcompress
from implicit_image_tpu.config import compose as jcompose
from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.sparsity import MaskingConfig as JMasking
from implicit_image_tpu.training.checkpoint import load_checkpoint as jload
from implicit_image_tpu.training.checkpoint import save_checkpoint as jsave
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import fit as jfit
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch.config import compose
from implicit_image_tpu_torch.convert import checkpoint_from_jax, params_from_jax
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.sparsity import MaskingConfig
from implicit_image_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

torch.set_num_threads(1)

MASKING = dict(density=0.5, interval=3, end_when=30)
IMG = np.random.default_rng(7).uniform(size=(12, 12, 3)).astype(np.float32)


def _fit(n, masking=True, **kw):
    m, c = build_model("siren", depth=4, hidden_size=16)
    tc = TrainConfig(num_steps=n, log_steps=4, segment_steps=kw.pop("segment_steps", 5))
    return fit(torch.Generator().manual_seed(0), m, c, get_grid(12, 12), IMG, tc,
               OptimConfig(lr=1e-3), MaskingConfig(**MASKING) if masking else None,
               device="cpu", **kw)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a), \
        np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b)
    return a.shape == b.shape and np.array_equal(a, b)


def _equal_state(ra, rb):
    for la, lb in zip(ra.params, rb.params):
        assert all(_same(la[k], lb[k]) for k in la)
    for ma, mb in zip(ra.opt_state.mu + ra.opt_state.nu, rb.opt_state.mu + rb.opt_state.nu):
        assert all(_same(ma[k], mb[k]) for k in ma)
    assert ra.opt_state.count == rb.opt_state.count
    for ma, mb in zip(ra.mask_state.masks, rb.mask_state.masks):
        assert _same(ma, mb)


@pytest.fixture(scope="module")
def interrupted(tmp_path_factory):
    """A 12-step RigL fit checkpointing every 5 steps, its step-5 checkpoint
    kept aside by the watch callback (it runs after the save)."""
    root = tmp_path_factory.mktemp("ck")
    ck = root / "checkpoint.npz"
    seen = []

    def watch(params, opt_state, step):
        seen.append(step)
        if step == 5:
            shutil.copy(ck, root / "at5.npz")

    full = _fit(12, checkpoint_path=ck, watch=watch)
    return root, full, seen


def test_boundaries_and_resume_are_bit_exact(interrupted):
    root, full, seen = interrupted
    assert seen == [5, 10, 12]
    assert load_checkpoint(root / "checkpoint.npz")["step"] == 12
    resumed = _fit(12, resume_from=root / "at5.npz")
    _equal_state(resumed, full)
    for key in ("loss", "psnr", "density", "prune_rate"):
        np.testing.assert_array_equal(resumed.metrics[key], full.metrics[key][5:])


def test_resume_with_another_segment_length(interrupted):
    """The JAX package's resume raises a KeyError when segment_steps changes
    (a remainder length it never compiled); the port's boundaries are a
    cadence only."""
    root, full, _ = interrupted
    resumed = _fit(12, resume_from=root / "at5.npz", segment_steps=4,
                   checkpoint_path=root / "again.npz")
    _equal_state(resumed, full)
    assert load_checkpoint(root / "again.npz")["step"] == 12


def test_resume_past_the_budget_raises(interrupted):
    root, _, _ = interrupted
    with pytest.raises(ValueError, match="nothing to resume"):
        _fit(5, resume_from=root / "at5.npz")


def test_port_checkpoint_loads_in_jax(interrupted):
    root, _, _ = interrupted
    ours = load_checkpoint(root / "at5.npz")
    theirs = jload(root / "at5.npz")
    assert theirs["step"] == ours["step"] == 5
    assert int(theirs["opt_state"].count) == ours["opt_state"].count
    for tree in ("params",):
        for a, b in zip(ours[tree], theirs[tree]):
            assert all(_same(a[k], np.asarray(b[k])) for k in a)
    for a, b in zip(ours["opt_state"].mu, theirs["opt_state"].mu):
        assert all(_same(a[k], np.asarray(b[k])) for k in a)
    for a, b in zip(ours["mask_state"].masks, theirs["mask_state"].masks):
        assert _same(a, None if b is None else np.asarray(b))
    for name in ("baseline_nonzero", "total_params", "final_sparsity"):
        assert _same(getattr(ours["mask_state"], name),
                     np.asarray(getattr(theirs["mask_state"], name)))
    assert theirs["key"].shape == (2,)


def test_jax_checkpoint_loads_and_resumes_in_port(tmp_path):
    """JAX writes a 5-step dense checkpoint; the port reads every field and
    resumes it to step 10, ending within the fit parity bound of JAX's own
    10-step fit."""
    jm, jc = jbuild("siren", depth=4, hidden_size=16)
    init = jax.tree.map(jnp.asarray, jm.init(jax.random.PRNGKey(1), jc))
    tc = JTrain(num_steps=10, log_steps=5, segment_steps=5, matmul_precision="tensorfloat32")
    ck = tmp_path / "jax.npz"
    seen = []

    def watch(params, opt_state, step):
        seen.append(step)
        if step == 5:
            shutil.copy(ck, tmp_path / "j5.npz")

    jres = jfit(jax.random.PRNGKey(0), jm, jc, jgrid(12, 12), IMG, tc, JOptim(lr=1e-3),
                checkpoint_path=ck, watch=watch, init_params=init)
    assert seen == [5, 10]
    state = checkpoint_from_jax(tmp_path / "j5.npz")
    ref = jload(tmp_path / "j5.npz")
    assert state["step"] == 5 and state["opt_state"].count == int(ref["opt_state"].count)
    for a, b in zip(state["params"], ref["params"]):
        assert all(_same(a[k], np.asarray(b[k])) for k in a)
    m, c = build_model("siren", depth=4, hidden_size=16)
    tres = fit(torch.Generator().manual_seed(0), m, c, get_grid(12, 12), IMG,
               TrainConfig(num_steps=10, log_steps=5), OptimConfig(lr=1e-3),
               resume_from=tmp_path / "j5.npz", device="cpu")
    assert tres.metrics["loss"].shape == (5,)
    for a, b in zip(tres.params, jres.params):
        for k in a:
            ref = np.asarray(b[k])
            assert np.abs(a[k].numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_sparse_jax_checkpoint_round_trips_through_the_port(tmp_path):
    """A JAX RigL checkpoint: the port saves what it loaded, and JAX reads
    the same masks and scalars back."""
    jm, jc = jbuild("siren", depth=4, hidden_size=16)
    tc = JTrain(num_steps=6, log_steps=6, segment_steps=6, matmul_precision="tensorfloat32")
    jfit(jax.random.PRNGKey(0), jm, jc, jgrid(12, 12), IMG, tc, JOptim(lr=1e-3),
         JMasking(**MASKING), checkpoint_path=tmp_path / "j.npz")
    state = checkpoint_from_jax(tmp_path / "j.npz")
    save_checkpoint(tmp_path / "t.npz", state["params"], state["opt_state"],
                    state["mask_state"], step=state["step"])
    a, b = jload(tmp_path / "j.npz"), jload(tmp_path / "t.npz")
    for ma, mb in zip(a["mask_state"].masks, b["mask_state"].masks):
        assert (ma is None and mb is None) or np.array_equal(np.asarray(ma), np.asarray(mb))
    for name in ("baseline_nonzero", "total_params", "adjusted_growth", "adj_sum",
                 "adj_count", "final_sparsity"):
        assert np.array_equal(np.asarray(getattr(a["mask_state"], name)),
                              np.asarray(getattr(b["mask_state"], name)))
    # jsave writes what the port reads back
    jsave(tmp_path / "j2.npz", a["params"], a["opt_state"], a["mask_state"], a["key"], 6)
    assert load_checkpoint(tmp_path / "j2.npz")["step"] == 6


CLI = ["img=synthetic", "img.height=12", "img.width=12", "mlp.depth=3", "mlp.hidden_size=8",
       "train.num_steps=10", "train.log_steps=5", "train.segment_steps=4", "masking=none",
       "quant=none", "entropy_coding=none", "train.watch=true", "train.checkpoint=true"]


def test_watch_writes_jax_rows(tmp_path):
    tcompress.main(compose(CLI + ["device=cpu"]), run_dir=str(tmp_path / "t"))
    jcompress.main(jcompose(CLI), run_dir=str(tmp_path / "j"))
    rows = [json.loads(x) for x in (tmp_path / "t" / "histograms.jsonl").read_text().splitlines()]
    jrows = [json.loads(x) for x in (tmp_path / "j" / "histograms.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [r["step"] for r in jrows] == [4, 8, 10]
    for r, jr in zip(rows, jrows):
        assert r["prefix"] == jr["prefix"] == "watch"
        assert sorted(r["histograms"]) == sorted(jr["histograms"])
        for h in r["histograms"].values():
            assert len(h["counts"]) == 64 and h["min"] <= h["max"]
    assert load_checkpoint(tmp_path / "t" / "checkpoint.npz")["step"] == 10


def test_stop_at_psnr_with_resume_raises(tmp_path):
    with pytest.raises(ValueError, match="stop_at_psnr"):
        tcompress.main(compose(CLI + ["device=cpu", "train.stop_at_psnr=1.0",
                                      f"train.resume={tmp_path}/none.npz"]),
                       run_dir=str(tmp_path / "r"))


def test_cli_resume_logs_the_executed_window(tmp_path):
    """A run resumed at step 4 logs steps 5 and 10 only, and its final params
    equal the uninterrupted run's."""
    tcompress.main(compose(CLI + ["device=cpu"]), run_dir=str(tmp_path / "full"))
    short = [x for x in CLI if not x.startswith("train.num_steps")] + ["train.num_steps=4"]
    tcompress.main(compose(short + ["device=cpu"]), run_dir=str(tmp_path / "first"))
    tcompress.main(compose(CLI + ["device=cpu",
                                  f"train.resume={tmp_path}/first/checkpoint.npz"]),
                   run_dir=str(tmp_path / "rest"))
    lines = [json.loads(x) for x in (tmp_path / "rest" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines if x["prefix"] == "Train"] == [5, 10]
    a, b = np.load(tmp_path / "full" / "model.npz"), np.load(tmp_path / "rest" / "model.npz")
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
