"""Port parity: the sparsity modules (ERK init, decay schedules, prune,
growth, redistribution, the topology update).

The same numpy inputs, made from seeds, go through the JAX function and its
counterpart in implicit_image_tpu_torch. Scores are drawn from a few levels
so that many of them tie: both packages must order ties by index.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.sparsity import core as jcore
from implicit_image_tpu.sparsity import decay as jdecay
from implicit_image_tpu.sparsity import grow as jgrow
from implicit_image_tpu.sparsity import prune as jprune
from implicit_image_tpu.sparsity import redistribute as jredist
from implicit_image_tpu.sparsity.init_scheme import erdos_renyi_probs as j_erk
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.sparsity import core as tcore
from implicit_image_tpu_torch.sparsity import decay as tdecay
from implicit_image_tpu_torch.sparsity import grow as tgrow
from implicit_image_tpu_torch.sparsity import prune as tprune
from implicit_image_tpu_torch.sparsity import redistribute as tredist
from implicit_image_tpu_torch.sparsity.init_scheme import erdos_renyi_probs as t_erk
from implicit_image_tpu_torch.sparsity.init_scheme import init_masks

torch.set_num_threads(1)

STEPS = np.arange(0, 2001)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


def _tied(rng, shape, levels=5):
    """Values from a few levels (many exact ties), signs mixed, some zeros;
    multiples of 1/8, so sums over a few of them are exact in any order."""
    v = rng.integers(0, levels, shape).astype(np.float32) / 8
    return v * rng.choice(np.array([-1.0, 1.0], np.float32), shape)


def _mask(rng, shape, density):
    return (rng.uniform(size=shape) < density).astype(np.float32)


@pytest.mark.parametrize("density,kernel", [(0.5, True), (0.05, True), (0.3, False), (0.9, True)])
@pytest.mark.parametrize("depth,width", [(8, 128), (4, 32), (3, 16)])
def test_erdos_renyi_probs_equal(depth, width, density, kernel):
    shapes = [(2, width)] + [(width, width)] * (depth - 2) + [(width, 3)]
    assert t_erk(shapes, density, kernel) == j_erk(shapes, density, kernel)


def test_erk_default_protocol_densities():
    shapes = [(2, 128)] + [(128, 128)] * 6 + [(128, 3)]
    probs = t_erk(shapes, 0.5)
    assert probs[0] == probs[-1] == 1.0
    assert all(abs(p - 0.4967) < 1e-4 for p in probs[1:-1])
    expected = sum(p * np.prod(s) for p, s in zip(probs, shapes))
    assert abs(expected - 49472) < 1.0 and sum(np.prod(s) for s in shapes) == 98944


@pytest.mark.parametrize("name,args", [
    ("cosine_decay", (0.1, 1500)),
    ("cosine_decay", (0.3, 40, 0.01)),
    ("linear_decay", (0.1, 1500)),
    ("linear_decay", (0.25, 30)),
    ("magnitude_prune_decay", (0.5, 1500, 5, 10)),
    ("magnitude_prune_decay", (0.9, 40, 5, 10)),
])
def test_decay_schedules_bit_equal(name, args):
    """Over steps 0-2000, float32 bit for bit (the schedule's own previous
    value as the current sparsity, as the JAX function defaults)."""
    jv = np.asarray(jax.vmap(getattr(jdecay, name)(*args))(jnp.asarray(STEPS)))
    tf = getattr(tdecay, name)(*args)
    tv = np.array([tf(int(s)) for s in STEPS], np.float32)
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))


def test_magnitude_prune_decay_with_live_sparsity_bit_equal():
    cur = np.random.default_rng(0).uniform(0.0, 0.6, STEPS.size).astype(np.float32)
    jf, tf = jdecay.magnitude_prune_decay(0.5, 1500, 5, 10), tdecay.magnitude_prune_decay(
        0.5, 1500, 5, 10)
    jv = np.asarray(jax.vmap(jf)(jnp.asarray(STEPS), jnp.asarray(cur)))
    on_tensor = np.array([float(tf(int(s), torch.tensor(c))) for s, c in zip(STEPS, cur)],
                         np.float32)
    on_host = np.array([tf(int(s), c) for s, c in zip(STEPS, cur)], np.float32)
    np.testing.assert_array_equal(on_tensor, jv)
    np.testing.assert_array_equal(on_host, jv)


def test_ranks_break_ties_by_index():
    x = np.array([0.5, -1.0, 0.5, 0.0, -0.0, -1.0, 0.5], np.float32)
    _eq(jprune.ranks_ascending(jnp.asarray(x)), tprune.ranks_ascending(_t(x)))
    _eq(jprune.ranks_descending(jnp.asarray(x)), tprune.ranks_descending(_t(x)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.0371])
def test_magnitude_prune_identical(seed, rate):
    rng = np.random.default_rng(seed)
    w, m = _tied(rng, (32, 32)), _mask(rng, (32, 32), 0.6)
    nz = np.float32(m.sum())
    j = jprune.magnitude_prune(jnp.asarray(m), jnp.asarray(w), jnp.float32(rate), jnp.float32(nz))
    t = tprune.magnitude_prune(_t(m), _t(w), torch.tensor(rate), torch.tensor(nz))
    _eq(j, t)


@pytest.mark.parametrize("seed", range(3))
def test_global_magnitude_prune_identical(seed):
    rng = np.random.default_rng(seed)
    shapes = [(2, 16), (16, 16), (16, 16), (16, 3)]
    masks = [None] + [_mask(rng, s, 0.7) for s in shapes[1:]]
    weights = [_tied(rng, s) for s in shapes]
    baseline = np.float32(sum(m.sum() for m in masks if m is not None))
    jm, jr = jprune.global_magnitude_prune(
        [None if m is None else jnp.asarray(m) for m in masks],
        [jnp.asarray(w) for w in weights], jnp.float32(0.2), jnp.float32(baseline))
    tm, tr = tprune.global_magnitude_prune(
        [None if m is None else _t(m) for m in masks], [_t(w) for w in weights],
        torch.tensor(0.2), torch.tensor(baseline))
    assert tm[0] is None and jm[0] is None
    for a, b in zip(jm[1:], tm[1:]):
        _eq(a, b)
    assert float(tr) == float(jr)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fn", ["abs_grad_growth", "momentum_growth"])
def test_score_growth_identical(seed, fn):
    """Scores tie (a few levels, many exact zeros); num_growth may exceed
    the holes."""
    rng = np.random.default_rng(seed)
    m, w, g = _mask(rng, (24, 24), 0.5), _tied(rng, (24, 24)), _tied(rng, (24, 24), levels=3)
    for num in (0.0, 17.0, 130.0, 1000.0):
        jm, jw = getattr(jgrow, fn)(jnp.asarray(m), jnp.asarray(w), jnp.asarray(g),
                                    jnp.float32(num))
        tm, tw = getattr(tgrow, fn)(_t(m), _t(w), _t(g), torch.tensor(num))
        _eq(jm, tm)
        _eq(jw, tw)


@pytest.mark.parametrize("criterion", ["mean", "max"])
def test_struct_prune_identical(criterion):
    rng = np.random.default_rng(5)
    shape = (6, 5, 3, 3)
    m = np.broadcast_to(_mask(rng, (6, 5, 1, 1), 0.7), shape).copy()
    w = _tied(rng, shape)
    nz = np.float32(m.sum())
    j = jprune.struct_magnitude_prune(jnp.asarray(m), jnp.asarray(w), jnp.float32(0.3),
                                      jnp.float32(nz), criterion)
    t = tprune.struct_magnitude_prune(_t(m), _t(w), torch.tensor(0.3), torch.tensor(nz),
                                      criterion)
    _eq(j, t)


@pytest.mark.parametrize("criterion", ["mean", "min"])
def test_struct_growth_identical(criterion):
    rng = np.random.default_rng(6)
    shape = (6, 5, 3, 3)
    m = np.broadcast_to(_mask(rng, (6, 5, 1, 1), 0.4), shape).copy()
    w, g = _tied(rng, shape), _tied(rng, shape, levels=3)
    jm, jw = jgrow.struct_abs_grad_growth(jnp.asarray(m), jnp.asarray(w), jnp.asarray(g),
                                          jnp.float32(45.0), criterion=criterion)
    tm, tw = tgrow.struct_abs_grad_growth(_t(m), _t(w), _t(g), torch.tensor(45.0),
                                          criterion=criterion)
    _eq(jm, tm)
    _eq(jw, tw)


def test_redistribution_statistics_match():
    rng = np.random.default_rng(7)
    m, w, g, mom = (_mask(rng, (32, 32), 0.5), *(rng.normal(size=(32, 32)).astype(np.float32)
                                                 for _ in range(3)))
    args_j = [jnp.asarray(a) for a in (m, w, g, mom)]
    args_t = [_t(a) for a in (m, w, g, mom)]
    assert float(tredist.nonzero_redistribution(*args_t)) == float(
        jredist.nonzero_redistribution(*args_j))
    for name in ("momentum_redistribution", "grad_redistribution"):
        a = float(getattr(tredist, name)(*args_t))
        b = float(getattr(jredist, name)(*args_j))
        assert a == pytest.approx(b, rel=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_calc_redistributed_identical(seed):
    """The residual solver, with layers that hit their cap and ones that
    do not."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 9))
    variance = rng.dirichlet(np.ones(n) * 0.5).astype(np.float32)
    zeros = rng.integers(10, 3000, n).astype(np.float32)
    removed = rng.integers(0, 400, n).astype(np.float32)
    total = np.float32(removed.sum())
    adj = np.float32(rng.normal() * 20)
    j = jcore._calc_redistributed(*(jnp.asarray(a) for a in (variance, zeros, removed)),
                                  jnp.float32(total), jnp.float32(adj))
    t = tcore._calc_redistributed(*(_t(a) for a in (variance, zeros, removed)),
                                  torch.tensor(total), torch.tensor(adj))
    _eq(j, t)


def _configs():
    return {
        "RigL": dict(),
        "SNFS": dict(density=0.05, growth_mode="momentum", redistribution_mode="momentum"),
        "Pruning": dict(density=1.0, sparse_init="random", growth_mode="none",
                        prune_mode="global-magnitude", decay_schedule="magnitude-prune",
                        interval=10),
    }


@pytest.mark.parametrize("name", ["RigL", "SNFS", "Pruning"])
def test_update_connections_identical(name):
    """One topology update at d4 w32 from identical params, grads, momenta
    and masks: identical masks, params and MaskState scalars."""
    kw = _configs()[name]
    jm, jc = jbuild("siren", depth=4, hidden_size=32)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), jc))
    rng = np.random.default_rng(11)
    grads = [{k: _tied(rng, v.shape, levels=7) * 1e-3 for k, v in layer.items()} for layer in p]
    moms = [_tied(rng, layer["w"].shape, levels=7) for layer in p]
    shapes = [layer["w"].shape for layer in p]
    if name == "Pruning":
        lottery = None  # random init at density 1: the first layer unmasked, the rest dense
    else:
        lottery = [_mask(rng, s, 0.5) for s in shapes]
        kw = dict(kw, sparse_init="lottery-ticket")
    jcfg = jcore.MaskingConfig(name=name, **kw)
    tcfg = tcore.MaskingConfig(name=name, **kw)
    jstate = jcore.create_mask_state(jax.random.PRNGKey(0), p, jcfg, lottery_masks=lottery)
    tp = tuple({k: _t(v).clone() for k, v in layer.items()} for layer in p)
    tstate = tcore.create_mask_state(torch.Generator().manual_seed(0), tp, tcfg,
                                     lottery_masks=lottery)
    jp = jcore.apply_masks(p, jstate.masks)
    tcore.apply_masks_(tp, tstate.masks)
    for rate in (0.3, 0.05):
        jp, jstate = jcore.update_connections(
            jp, grads, [jnp.asarray(x) for x in moms], jstate, jnp.float32(rate),
            jax.random.PRNGKey(1), jcfg)
        tp, tstate = tcore.update_connections(
            tp, tuple({k: _t(v) for k, v in g.items()} for g in grads), [_t(x) for x in moms],
            tstate, np.float32(rate), None, tcfg)
        for a, b in zip(jstate.masks, tstate.masks):
            assert (a is None) == (b is None)
            if a is not None:
                _eq(a, b)
        for a, b in zip(jp, tp):
            for k in ("w", "b"):
                _eq(a[k], b[k])
        for field in ("baseline_nonzero", "total_params", "adjusted_growth", "adj_sum",
                      "adj_count"):
            assert float(getattr(tstate, field)) == float(getattr(jstate, field)), field
        assert float(tcore.total_density(tstate)) == float(jcore.total_density(jstate))


def test_mask_init_schemes():
    """Draws differ from jax.random's, so: ERK masks keep ~their layer's
    probability, random keeps the first layer unmasked, -dist keeps each
    layer's count, struct-* raises for MLPs (as in the JAX package)."""
    shapes = [(2, 128)] + [(128, 128)] * 6 + [(128, 3)]
    gen = torch.Generator().manual_seed(0)
    erk = init_masks(gen, shapes, 0.5)
    for m, p in zip(erk, t_erk(shapes, 0.5)):
        assert abs(float(m.mean()) - p) < 0.02
    rnd = init_masks(gen, shapes, 0.3, scheme="random")
    assert rnd[0] is None
    assert all(abs(float(m.mean()) - 0.3) < 4 * (0.21 / m.numel()) ** 0.5 for m in rnd[1:])
    shuffled = init_masks(gen, shapes, 0.5, scheme="lottery-ticket-dist",
                          lottery_masks=[m.numpy() for m in erk])
    assert [float(a.sum()) for a in shuffled] == [float(b.sum()) for b in erk]
    assert not torch.equal(shuffled[1], erk[1])
    with pytest.raises(ValueError):
        init_masks(gen, shapes, 0.5, scheme="struct-erdos-renyi")


def test_lottery_masks_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    masks = {f"layers.{i}.mask": _mask(rng, (8, 8), 0.5) for i in range(3)}
    np.savez(tmp_path / "mask.npz", **masks)
    for a, b in zip(jcore.load_lottery_masks(str(tmp_path / "mask.npz")),
                    tcore.load_lottery_masks(str(tmp_path / "mask.npz"))):
        _eq(a, b)


def test_small_dense_width_in_both_packages():
    from implicit_image_tpu.models import build_model_from_config as jfrom
    from implicit_image_tpu_torch.models import build_model_from_config as tfrom

    cfg = {"mlp": {"name": "siren", "depth": 8, "hidden_size": 128},
           "masking": {"name": "Small_Dense", "dense": True, "density": 0.2}}
    (_, jc), (_, tc) = jfrom(cfg), tfrom(cfg)
    assert jc.layer_dims == tc.layer_dims
    assert tc.layer_dims[1] == (57, 57)
    _, plain = build_model("siren", depth=8, hidden_size=128)
    assert plain.layer_dims[1] == (128, 128)
