"""The hand-written CUDA kernels of implicit_image_tpu_torch against their
plain-torch versions, on the card, and the paths around them that only the
card can check: the codebook finetune repeats bit for bit, MS-SSIM agrees
with the CPU, and a RigL fit on the card keeps each layer's weight count;
since the fit-options slice, the precision schedule's launches per mode,
the kernels under mixed precision, a bit-exact resume and a hashgrid fit
that repeats bit for bit; since the batched slice, K2 over a member axis
and batched fits, each member the bits of its single launch or fit; since
the slice of the CLI's last options, the QAT finetune, Shampoo and EKFAC
fits, and Fourier and Feathermap beyond fp32; since the layer-wise kernels,
every hidden width above 192 in every mode, over a member axis, and their
partial buffer against its plain mirror.

Every test here is marked `cuda` and skips (inside the test) without a CUDA
device: a CUDA kernel has no interpret mode. The file imports torch and the
port only, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -q
"""
import pytest
import torch

from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops import sine_mlp as sm

KEYS = ("w", "b")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision,fwd_tol,bwd_tol",
                         [("fp32", 1e-4, 1e-4), ("bf16", 1.5e-3, 2e-2),
                          ("fp32+mixed", 1.5e-3, 2e-2), ("bf16+mixed", 1.5e-3, 2e-2)])
@pytest.mark.parametrize("depth,hidden,n", [(8, 128, 4099), (4, 32, 200), (2, 64, 64),
                                            (3, 57, 300), (7, 128, 40000), (8, 182, 40000),
                                            (4, 256, 40000), (3, 512, 20000), (2, 192, 1000),
                                            (5, 130, 777)])
def test_kernels_match_plain(cuda_device, precision, fwd_tol, bwd_tol, depth, hidden, n):
    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    params = m.init(torch.Generator().manual_seed(0), c, cuda_device)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand((n, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((n, 3), generator=gen).to(cuda_device)
    before = dict(sm.LAUNCHES)
    out = sm.sine_mlp_fwd(params, x, c, precision)
    dx, grads = sm.sine_mlp_bwd(params, x, g, c, precision)
    torch.cuda.synchronize()
    if sm.kernel_width(hidden) > sm.KERNEL_WIDTHS[-1]:  # above 192: the layer-wise kernels
        assert _layer_launches(before, depth, fwd_calls=1, bwd_calls=1)
    else:
        launched = {k: sm.LAUNCHES[k] - before[k] for k in before}
        assert launched == {k: int(k in ("sine_mlp_fwd", "sine_mlp_bwd", "sum_partials"))
                            for k in before}
    ref = sm.siren_chain_reference(params, x, c, precision)
    assert float((out - ref).abs().max()) <= fwd_tol
    dx_r, grads_r = sm.siren_chain_backward_reference(params, x, g, c, precision)
    pairs = [(dx, dx_r)] + [(a[k], b[k]) for a, b in zip(grads, grads_r) for k in KEYS]
    for a, b in pairs:
        assert float((a - b).abs().max()) <= bwd_tol * float(b.abs().max())
    assert float(dx.abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("precision,other,fwd_tol,bwd_tol",
                         [("fp32", "bf16", 1e-4, 1e-4), ("bf16", "fp32", 1.5e-3, 2e-2)])
def test_limits_reject_the_other_modes_kernel(cuda_device, precision, other, fwd_tol, bwd_tol):
    """Control for the limits above: the kernel of the other precision mode,
    held to this mode's plain chain, fails them."""
    _check_other_mode_fails(cuda_device, precision, other, fwd_tol, bwd_tol, 8, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,other,fwd_tol,bwd_tol",
                         [("fp32", "bf16", 1e-4, 1e-4), ("bf16", "fp32", 1.5e-3, 2e-2)])
def test_limits_reject_the_other_modes_kernel_at_w256(cuda_device, precision, other, fwd_tol,
                                                      bwd_tol):
    """The same control at d4/w256 (the layer-wise kernels)."""
    _check_other_mode_fails(cuda_device, precision, other, fwd_tol, bwd_tol, 4, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,other,fwd_tol,bwd_tol",
                         [("fp32", "bf16", 1e-4, 1e-4), ("bf16", "fp32", 1.5e-3, 2e-2)])
@pytest.mark.parametrize("depth,hidden", [(8, 182), (3, 512)])
def test_limits_reject_the_other_modes_kernel_at_w182_and_w512(cuda_device, precision, other,
                                                               fwd_tol, bwd_tol, depth, hidden):
    """The same control at the finals width (kernel 192: the wgmma backward,
    dW summed in it) and at 512 (the layer-wise kernels)."""
    _check_other_mode_fails(cuda_device, precision, other, fwd_tol, bwd_tol, depth, hidden)


def _check_other_mode_fails(cuda_device, precision, other, fwd_tol, bwd_tol, depth, hidden):
    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    params = m.init(torch.Generator().manual_seed(0), c, cuda_device)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand((4099, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((4099, 3), generator=gen).to(cuda_device)
    out = sm.sine_mlp_fwd(params, x, c, other)
    dx, grads = sm.sine_mlp_bwd(params, x, g, c, other)
    assert float((out - sm.siren_chain_reference(params, x, c, precision)).abs().max()) > fwd_tol
    dx_r, grads_r = sm.siren_chain_backward_reference(params, x, g, c, precision)
    pairs = [(dx, dx_r)] + [(a[k], b[k]) for a, b in zip(grads, grads_r) for k in KEYS]
    assert max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs) > bwd_tol


@pytest.mark.cuda
def test_kernel_backward_repeats_bit_for_bit(cuda_device):
    for precision in ("fp32", "bf16", "fp32+mixed", "bf16+mixed"):
        _check_backward_repeats(cuda_device, 128, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
def test_wide_kernel_backward_repeats_bit_for_bit(cuda_device, precision):
    """The width-192 backward (its dW summed in the kernel) + sum_partials at
    182, and the layer-wise kernels + sum_partials at 256 and 512, in every
    mode; the forward of each width too."""
    for hidden in (182, 256, 512):
        _check_backward_repeats(cuda_device, hidden, precision)


def _check_backward_repeats(cuda_device, hidden, precision="fp32"):
    m, c = build_model("siren", depth=5, hidden_size=hidden)
    params = m.init(torch.Generator().manual_seed(0), c, cuda_device)
    x = (torch.rand((20000, 2), generator=torch.Generator().manual_seed(2)) * 2 - 1).to(
        cuda_device)
    g = torch.ones((20000, 3), device=cuda_device)
    _, first = sm.sine_mlp_bwd(params, x, g, c, precision)
    _, second = sm.sine_mlp_bwd(params, x, g, c, precision)
    for a, b in zip(first, second):
        for k in KEYS:
            assert torch.equal(a[k], b[k])
    assert torch.equal(sm.sine_mlp_fwd(params, x, c, precision),
                       sm.sine_mlp_fwd(params, x, c, precision))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(132, 99_844), (1, 8), (7, 1_000), (133, 4_096),
                                   (1, 99_844), (2, 99_844), (264, 40_000)])
def test_sum_partials_equals_its_mirror_bit_for_bit(cuda_device, shape):
    """The partial-sum kernel adds in the order of sum_partials_reference
    with the library's group count: the same bits, twice; and it computes
    the function of partials.sum(0) to 1e-6 relative."""
    assert sm._lib().sum_partials_groups() == sm.SUM_PARTIALS_GROUPS
    partials = torch.randn(shape, generator=torch.Generator().manual_seed(7)).to(cuda_device)
    before = sm.LAUNCHES["sum_partials"]
    first, second = sm.sum_partials(partials), sm.sum_partials(partials)
    torch.cuda.synchronize()
    assert sm.LAUNCHES["sum_partials"] == before + 2
    assert torch.equal(first, sm.sum_partials_reference(partials))
    assert torch.equal(first, second)
    library = partials.sum(0)
    assert float((first - library).abs().max()) <= 1e-6 * float(library.abs().max())


@pytest.mark.cuda
def test_sum_partials_rejects_what_float4_loads_cannot_take(cuda_device):
    with pytest.raises(ValueError, match="multiple of 4"):
        sm.sum_partials(torch.zeros((8, 1_002), device=cuda_device))
    flat = torch.zeros(8 * 1_000 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        sm.sum_partials(flat[1:].view(8, 1_000))  # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        sm.sum_partials(torch.zeros((1_000, 8), device=cuda_device).t())
    with pytest.raises(ValueError, match="float32"):
        sm.sum_partials(torch.zeros((8, 1_000), dtype=torch.float64, device=cuda_device))


def _layer_launches(before, depth, fwd_calls=0, bwd_calls=0, batched=False):
    """The launches the layer-wise kernels add over `fwd_calls` forwards and
    `bwd_calls` backwards (one band): a forward is depth launches of
    sine_mlp_layer_fwd, a backward depth - 1 more of them (its recompute),
    depth of sine_mlp_layer_bwd, depth - 2 of sine_mlp_layer_dw and one
    sum_partials; nothing else launches."""
    suffix = "_batched" if batched else ""
    want = {k: 0 for k in before}
    want["sine_mlp_layer_fwd" + suffix] = depth * fwd_calls + (depth - 1) * bwd_calls
    want["sine_mlp_layer_bwd" + suffix] = depth * bwd_calls
    want["sine_mlp_layer_dw" + suffix] = (depth - 2) * bwd_calls
    want["sum_partials" + suffix] = bwd_calls
    return {k: sm.LAUNCHES[k] - before[k] for k in before} == want


@pytest.mark.cuda
def test_kernel_runs_width_576(cuda_device):
    """A SIREN of width 576 (kernel width 640) runs on the layer-wise
    kernels on the card, forward and backward, within the fp32 limits of
    the plain chain, and launches nothing else."""
    m, c = build_model("siren", depth=3, hidden_size=576)
    params = m.init(torch.Generator().manual_seed(0), c, cuda_device)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand((3000, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((3000, 3), generator=gen).to(cuda_device)
    before = dict(sm.LAUNCHES)
    out = sm.sine_mlp_fwd(params, x, c, "fp32")
    dx, grads = sm.sine_mlp_bwd(params, x, g, c, "fp32")
    torch.cuda.synchronize()
    assert _layer_launches(before, 3, fwd_calls=1, bwd_calls=1)
    assert float((out - sm.siren_chain_reference(params, x, c, "fp32")).abs().max()) <= 1e-4
    dx_r, grads_r = sm.siren_chain_backward_reference(params, x, g, c, "fp32")
    for a, b in [(dx, dx_r)] + [(a[k], b[k]) for a, b in zip(grads, grads_r) for k in KEYS]:
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("precision,fwd_tol,bwd_tol",
                         [("fp32", 1e-4, 1e-4), ("bf16", 1.5e-3, 2e-2),
                          ("fp32+mixed", 1.5e-3, 2e-2), ("bf16+mixed", 1.5e-3, 2e-2)])
@pytest.mark.parametrize("depth,hidden,n", [(4, 640, 20000), (2, 700, 4099), (8, 1024, 9000)])
def test_layer_kernels_match_plain(cuda_device, precision, fwd_tol, bwd_tol, depth, hidden, n):
    """The layer-wise kernels (widths above 192) against the plain chain at
    the fused kernels' limits, in every mode, with their launch counts."""
    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    params = m.init(torch.Generator().manual_seed(0), c, cuda_device)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand((n, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((n, 3), generator=gen).to(cuda_device)
    before = dict(sm.LAUNCHES)
    out = sm.sine_mlp_fwd(params, x, c, precision)
    dx, grads = sm.sine_mlp_bwd(params, x, g, c, precision)
    torch.cuda.synchronize()
    assert _layer_launches(before, depth, fwd_calls=1, bwd_calls=1)
    assert float((out - sm.siren_chain_reference(params, x, c, precision)).abs().max()) <= fwd_tol
    dx_r, grads_r = sm.siren_chain_backward_reference(params, x, g, c, precision)
    for a, b in [(dx, dx_r)] + [(a[k], b[k]) for a, b in zip(grads, grads_r) for k in KEYS]:
        assert float((a - b).abs().max()) <= bwd_tol * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
def test_layer_kernels_over_a_member_axis_are_single_launches(cuda_device, precision):
    """K1 and K2 over 3 members at width 640: member m's outputs and
    gradients are the bits of its single launches, in every mode."""
    m, c = build_model("siren", depth=4, hidden_size=640)
    members = [m.init(torch.Generator().manual_seed(i), c, cuda_device) for i in range(3)]
    gen = torch.Generator().manual_seed(7)
    x = (torch.rand((5000, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((3, 5000, 3), generator=gen).to(cuda_device)
    before = dict(sm.LAUNCHES)
    out = sm.sine_mlp_fwd_batched(members, x, c, precision)
    dx, grads = sm.sine_mlp_bwd_batched(members, x, g, c, precision)
    torch.cuda.synchronize()
    assert _layer_launches(before, 4, fwd_calls=1, bwd_calls=1, batched=True)
    for i, p in enumerate(members):
        assert torch.equal(out[i], sm.sine_mlp_fwd(p, x, c, precision))
        dx1, g1 = sm.sine_mlp_bwd(p, x, g[i], c, precision)
        assert torch.equal(dx[i], dx1)
        for a, b in zip(grads, g1):
            for k in KEYS:
                assert torch.equal(a[k][i], b[k]), (i, k)


def _autograd_pair(members, x, g, c, precision):
    """K1 and K2 under autograd (the fit's path: the stash from K1, K2 with
    no recompute) over a member axis, or on one params tuple: (out, dx,
    grads, the stash as K1 filled it, the launches K2 added)."""
    batched = isinstance(members, list)
    leaves = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
              for layer in (sm.stack_members(members) if batched else members)]
    x = x.clone().requires_grad_(True)
    flat = [t for layer in leaves for t in (layer["w"], layer["b"])]
    fn = sm.SineMLPBatchedFunction if batched else sm.SineMLPFunction
    out = fn.apply(x, c, precision, True, *flat)
    stash = out.grad_fn.z.clone()
    before = dict(sm.LAUNCHES)
    out.backward(g)
    torch.cuda.synchronize()
    added = {k: sm.LAUNCHES[k] - before[k] for k in before}
    return (out.detach(), x.grad, [{k: v.grad for k, v in layer.items()} for layer in leaves],
            stash, added)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
def test_layer_autograd_path_is_the_api_path(cuda_device, precision):
    """Above 512 under autograd K1 fills the z stash in its bands and K2
    takes it: at d4/w640 on 250,000 rows (2 bands; 3 over 2 members) the
    stash is the bits of K2's recompute (`sine_mlp_layer_stash`, one pass),
    K2 launches no sine_mlp_layer_fwd, and out, dx and every gradient are
    the bits of sine_mlp_fwd / sine_mlp_bwd (and of the member-axis
    launches), in every mode."""
    m, c = build_model("siren", depth=4, hidden_size=640)
    members = [m.init(torch.Generator().manual_seed(i), c, cuda_device) for i in range(2)]
    n = 250000
    assert n > sm.layer_band_rows(640)
    gen = torch.Generator().manual_seed(3)
    x = (torch.rand((n, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((2, n, 3), generator=gen).to(cuda_device)
    for batched in (False, True):
        got = _autograd_pair(members if batched else members[0], x, g if batched else g[0], c,
                             precision)
        out, dx, grads, stash, added = got
        assert torch.equal(stash, sm.sine_mlp_layer_stash(members if batched else members[:1],
                                                          x, c, precision))
        suffix = "_batched" if batched else ""
        assert added == {k: 0 for k in added} | {"sine_mlp_layer_bwd" + suffix: 4,
                                                 "sine_mlp_layer_dw" + suffix: 2,
                                                 "sum_partials" + suffix: 1}
        if batched:
            api = (sm.sine_mlp_fwd_batched(members, x, c, precision),
                   *sm.sine_mlp_bwd_batched(members, x, g, c, precision))
            dx_api = api[1].sum(0)  # x shared by both members
        else:
            api = (sm.sine_mlp_fwd(members[0], x, c, precision),
                   *sm.sine_mlp_bwd(members[0], x, g[0], c, precision))
            dx_api = api[1]
        assert torch.equal(out, api[0]) and torch.equal(dx, dx_api)
        for a, b in zip(grads, api[2]):
            for k in KEYS:
                assert torch.equal(a[k], b[k]), (batched, k)


@pytest.mark.cuda
def test_layer_partials_match_their_mirror(cuda_device):
    """The layer-wise backward's partial buffer against its plain mirror
    (`siren_chain_layer_partials`, the same slices and dW splits) within
    1e-4 of its largest magnitude, and sum_partials over it bit for bit
    its mirror's order."""
    m, c = build_model("siren", depth=4, hidden_size=640)
    params = m.init(torch.Generator().manual_seed(0), c, cuda_device)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand((9000, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((9000, 3), generator=gen).to(cuda_device)
    _, part = sm.sine_mlp_layer_partials(params, x, g, c, "fp32")
    assert part.shape[0] == sm.layer_slices(
        9000, 640, torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    mirror = sm.siren_chain_layer_partials([{k: v.cpu() for k, v in p.items()} for p in params],
                                           x.cpu(), g.cpu(), c, "fp32", part.shape[0])
    # the slices' floats past the gradients (their 16-byte padding) are not written
    used = sum(sm.partial_layout(9000, 4, 2, 640, 3, cuda_device)[2])
    mirror = mirror[:, :used]
    assert float((part.cpu()[:, :used] - mirror).abs().max()) <= 1e-4 * float(mirror.abs().max())
    assert torch.equal(sm.sum_partials(part), sm.sum_partials_reference(part))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("hidden,n", [(640, 3000), (1024, 1500)])
def test_layer_hidden_forward_matches_its_plain_version(cuda_device, precision, hidden, n):
    """One hidden sine_mlp_layer_fwd launch (wgmma, six bf16 passes in fp32,
    K in groups of 128) on a SIREN's a_0, W_1, b_1 against
    layer_fwd_reference: z within 1e-5 of max |z|, a_1 within omega times
    that (fp32) or one bf16 step of it (its rounding), twice the same bits;
    W's planes made once give the same bits as W."""
    m, c = build_model("siren", depth=4, hidden_size=hidden)
    p = m.init(torch.Generator().manual_seed(6), c, cuda_device)
    gen = torch.Generator().manual_seed(7)
    x = (torch.rand((n, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((n, 3), generator=gen).to(cuda_device)
    a, _ = sm.siren_chain_dw_operands(p, x, g, c, precision)
    bf16, mixed = sm.precision_modes(precision)
    layer = sm._rnd_params(p, mixed)[1]
    omega = float(c.hidden_omega_0)
    z, a1 = sm.sine_mlp_layer_fwd(a[0], layer["w"], layer["b"], omega, precision, stash=True)
    planes = sm._layer_planes(layer["w"][None], bf16, mixed)[0]
    z2, a2 = sm.sine_mlp_layer_fwd(a[0], planes, layer["b"], omega, precision, stash=True)
    zp, ap = sm.layer_fwd_reference(a[0], layer["w"], layer["b"], omega, precision)
    torch.cuda.synchronize()
    z_err = float((z - zp).abs().max())
    assert z_err <= 1e-5 * float(zp.abs().max()), z_err
    a_tol = 8e-3 if bf16 or mixed else omega * 1e-5 * float(zp.abs().max())
    assert float((a1 - ap).abs().max()) <= a_tol
    assert torch.equal(z, z2) and torch.equal(a1, a2)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("hidden,n", [(640, 3000), (1024, 1500)])
def test_layer_hidden_backward_matches_its_plain_version(cuda_device, precision, hidden, n):
    """One hidden sine_mlp_layer_bwd launch (wgmma, six bf16 passes in fp32,
    the epilogue under the next tile's products) on a SIREN's own G_l, W_l
    and z_{l-1} (l = 2, and l = 1 with x: dW_0) against layer_bwd_reference:
    G_{l-1} within 1e-5 of max |G| in fp32 (8e-3 where the modes round it or
    ga to bf16: one step of its rounding), A_{l-1} within 1e-5 (8e-3), the
    slices' db and dW_0 summed within 1e-5 (8e-3) of the largest column sum
    of |G| (of |x|^T |G|); twice the same bits; W^T's planes made once give
    the same bits as W."""
    m, c = build_model("siren", depth=4, hidden_size=hidden)
    p = m.init(torch.Generator().manual_seed(11), c, cuda_device)
    gen = torch.Generator().manual_seed(12)
    x = (torch.rand((n, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = (torch.randn((n, 3), generator=gen) / n).to(cuda_device)
    bf16, mixed = sm.precision_modes(precision)
    params = sm._rnd_params(p, mixed)
    om = sm._omegas(c, 4)
    a, zs = sm._rnd(x, bf16 or mixed), []
    for i in range(3):
        zs.append(a @ sm._rnd(params[i]["w"], bf16) + params[i]["b"])
        a = sm._rnd(sm.fast_sin(om[i] * zs[-1]), bf16 or mixed)
    gl = {}
    sm._chain_backward(params, x, g, c, precision,
                       lambda i, a_prev, gzb, gz: gl.__setitem__(i, gzb))
    tol = 8e-3 if bf16 or mixed else 1e-5
    for l in (2, 1):
        xl = x if l == 1 else None
        args = (gl[l], params[l]["w"], zs[l - 1], om[l - 1], precision)
        got = sm.sine_mlp_layer_bwd(*args, x=xl)
        again = sm.sine_mlp_layer_bwd(*args, x=xl)
        planes = sm._layer_planes(params[l]["w"].t()[None], bf16, mixed)[0]
        made = sm.sine_mlp_layer_bwd(gl[l], planes, zs[l - 1], om[l - 1], precision, x=xl)
        gp, ap, dbp, dwp = sm.layer_bwd_reference(*args, x=xl)
        torch.cuda.synchronize()
        for t in (got, again, made):
            assert all((u is None) == (v is None) for u, v in zip(t, got))
        assert all(u is None or (torch.equal(u, v) and torch.equal(u, w))
                   for u, v, w in zip(got, again, made)), l
        assert float((got[0] - gp).abs().max()) <= tol * float(gp.abs().max()), l
        assert float((got[1] - ap).abs().max()) <= max(tol, 1e-5), l
        # the column sums of |G| (|gz| within a step of its rounding)
        assert float((got[2].sum(0) - dbp).abs().max()) <= tol * float(gp.abs().sum(0).max())
        if l == 1:
            scale = float((sm._rnd(x, bf16 or mixed).abs().t() @ gp.abs()).max())
            assert float((got[3].sum(0) - dwp).abs().max()) <= tol * scale
        else:
            assert got[3] is None


def _layer_kind_operands(dev, depth, hidden, n, precision, seed, in_size=2, out_size=3):
    """A SIREN's own operands of its first- and last-layer launches, in the
    chain's rounding: (params, om, x, g, zs, a_L, G_0)."""
    m, c = build_model("siren", depth=depth, hidden_size=hidden, input_size=in_size,
                       output_size=out_size)
    p = m.init(torch.Generator().manual_seed(seed), c, dev)
    gen = torch.Generator().manual_seed(seed + 1)
    x = (torch.rand((n, in_size), generator=gen) * 2 - 1).to(dev)
    g = (torch.randn((n, out_size), generator=gen) / n).to(dev)
    bf16, mixed = sm.precision_modes(precision)
    params = sm._rnd_params(p, mixed)
    om = sm._omegas(c, depth)
    _, zs = sm._chain_forward(p, x, c, precision, keep=True)
    a_l = sm._rnd(sm.fast_sin(om[-2] * zs[-1]), bf16 or mixed)
    gl = {}
    sm._chain_backward(params, x, g, c, precision,
                       lambda i, a_prev, gzb, gz: gl.__setitem__(i, gzb))
    return params, om, x, g, zs, a_l, gl[0]


def _kind_calls(ops, precision, depth):
    """The four kinds' launches on `ops` (_layer_kind_operands') and their
    plain versions: {kind: (call, plain)}, each result a tuple."""
    params, om, x, g, zs, a_l, g0 = ops
    xl = x if depth == 2 else None
    return {
        "fwd first": (lambda: sm.sine_mlp_layer_fwd_first(x, params[0]["w"], params[0]["b"],
                                                          om[0], precision, stash=True),
                      lambda: sm.layer_fwd_first_reference(x, params[0]["w"], params[0]["b"],
                                                           om[0], precision)),
        "fwd last": (lambda: (sm.sine_mlp_layer_fwd_last(a_l, params[-1]["w"], params[-1]["b"],
                                                         precision),),
                     lambda: (sm.layer_fwd_last_reference(a_l, params[-1]["w"],
                                                          params[-1]["b"], precision),)),
        "bwd last": (lambda: sm.sine_mlp_layer_bwd_last(g, params[-1]["w"], zs[-1], om[-2],
                                                        precision, x=xl),
                     lambda: sm.layer_bwd_last_reference(g, params[-1]["w"], zs[-1], om[-2],
                                                         precision, x=xl)),
        "bwd first": (lambda: (sm.sine_mlp_layer_bwd_first(g0, params[0]["w"], precision),),
                      lambda: (sm.layer_bwd_first_reference(g0, params[0]["w"], precision),)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("depth,hidden,n", [(4, 640, 3000), (4, 1024, 1500), (2, 640, 1000)])
def test_layer_fma_kinds_match_their_plain_versions(cuda_device, precision, depth, hidden, n):
    """Each first- and last-layer launch alone (the streaming passes:
    sine_mlp_layer_fwd first and last, sine_mlp_layer_bwd last and first) on
    a SIREN's own operands against its plain version: the elementwise
    outputs (z_0, a_0, G_L) within 1e-5 of their largest value in fp32 (8e-3
    where a mode rounds them to bf16: a step of that rounding), the sums
    (out, dx, and the slices' db_L, dW_{D-1}, db_{D-1}, dW_0 added up)
    within LAYER_TOL's backward limits (chip_smoke.py: 1e-4 fp32, 2e-2 the
    others) of their largest value; twice the same bits; over a member axis
    of 2 (the SIREN and a second) each member the bits of its single
    launch. Depth 2 runs the backward's last layer with dW_0."""
    _check_fma_kinds(cuda_device, precision, depth, hidden, n, 2, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("depth,hidden,n,in_size,out_size",
                         [(4, 640, 3000, 3, 6), (2, 1024, 1500, 3, 4), (4, 1024, 1000, 1, 8)])
def test_layer_fma_kinds_at_other_counts_match_their_plain_versions(cuda_device, precision,
                                                                    depth, hidden, n, in_size,
                                                                    out_size):
    """test_layer_fma_kinds_match_their_plain_versions at input and output
    counts other than an image's 2 and 3, where the streaming passes run
    their loops to MAX_IO under a guard (the backward's last layer with 6,
    4 and 8 outputs, at depth 2 summing dW_0 over 3 inputs; the forward's
    first layer with 3 and 1 inputs)."""
    _check_fma_kinds(cuda_device, precision, depth, hidden, n, in_size, out_size)


def _check_fma_kinds(cuda_device, precision, depth, hidden, n, in_size, out_size):
    bf16, mixed = sm.precision_modes(precision)
    elem = 8e-3 if bf16 or mixed else 1e-5
    sums = 2e-2 if bf16 or mixed else 1e-4
    ops = _layer_kind_operands(cuda_device, depth, hidden, n, precision, 21, in_size, out_size)
    other = _layer_kind_operands(cuda_device, depth, hidden, n, precision, 23, in_size, out_size)
    calls, more = _kind_calls(ops, precision, depth), _kind_calls(other, precision, depth)
    for kind, (call, plain) in calls.items():
        got, again, ref = call(), call(), plain()
        torch.cuda.synchronize()
        assert all(u is None or torch.equal(u, v) for u, v in zip(got, again)), kind
        for i, (k, r) in enumerate(zip(got, ref)):
            if r is None:
                assert k is None, (kind, i)
                continue
            if kind == "bwd last" and i > 0:  # the slices' sums
                k = k.sum(0)
            tol = elem if (kind, i) in (("fwd first", 0), ("fwd first", 1), ("bwd last", 0)) \
                else sums
            assert float((k - r).abs().max()) <= tol * float(r.abs().max()) + 1e-30, (kind, i)
        # over a member axis: the two SIRENs' operands stacked, one launch
        single = (got, more[kind][0]())
        batched = _kind_batched(kind, ops, other, precision, depth)
        torch.cuda.synchronize()
        for mm in range(2):
            assert all(u is None or torch.equal(u[mm], v)
                       for u, v in zip(batched, single[mm])), (kind, mm)


def _kind_batched(kind, ops, other, precision, depth):
    """The kind's launch over a member axis of the two SIRENs' operands."""
    st = lambda i: torch.stack([ops[i], other[i]])  # noqa: E731
    w = lambda l, k: torch.stack([ops[0][l][k], other[0][l][k]])  # noqa: E731
    if kind == "fwd first":
        return sm.sine_mlp_layer_fwd_first(st(2), w(0, "w"), w(0, "b"), ops[1][0], precision,
                                           stash=True)
    if kind == "fwd last":
        return (sm.sine_mlp_layer_fwd_last(st(5), w(-1, "w"), w(-1, "b"), precision),)
    if kind == "bwd last":
        return sm.sine_mlp_layer_bwd_last(st(3), w(-1, "w"), torch.stack([ops[4][-1],
                                                                          other[4][-1]]),
                                          ops[1][-2], precision,
                                          x=st(2) if depth == 2 else None)
    return (sm.sine_mlp_layer_bwd_first(st(6), w(0, "w"), precision),)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("h", [256, 384, 640])
def test_layer_dw_matches_its_plain_version_over_row_groups(cuda_device, precision, h):
    """sine_mlp_layer_dw (wgmma, the rows in groups of 1,024) at widths 256,
    384 and 640 on 70,000 rows (66 / 44 / 26 splits of ~1,060 / 1,590 /
    2,700 rows: one to three groups each) against its plain version in
    float64: within 1e-5 of max |dW| per split; twice the same bits."""
    bf16, mixed = sm.precision_modes(precision)
    gen = torch.Generator().manual_seed(8)
    n = 70_000
    a = sm._rnd(torch.sin(torch.randn((n, h), generator=gen) * 3), bf16 or mixed).to(cuda_device)
    g = sm._rnd(torch.randn((n, h), generator=gen) / n, bf16).to(cuda_device)
    slices = sm.layer_slices(n, h, torch.cuda.get_device_properties(cuda_device)
                             .multi_processor_count)
    runs = []
    for _ in range(2):
        part = torch.zeros((slices, h * h + 4), device=cuda_device)
        sm.sine_mlp_layer_dw(a, g, part, 2, precision)
        runs.append(part)
    want = torch.stack([a[r0:r1].double().t() @ g[r0:r1].double()
                        for r0, r1 in sm.dw_row_splits(n, slices)])
    got = runs[0][:, 2: 2 + h * h].reshape(slices, h, h).double()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_kernel_widths_and_partial_layout(cuda_device):
    """The library's kernel widths and tile rows are KERNEL_TILE_ROWS (each
    width up to 192 runs on the first kernel width at or above it, above
    192 at the next multiple of 128, as kernel_width() says, for every
    width from 1 to 4096); the partial buffer has one block per SM, at most
    one per tile of the width's rows, and 16-byte-aligned slices."""
    lib = sm._lib()
    for h in range(1, 4097):
        want = (next((k for k in sm.KERNEL_WIDTHS if h <= k), 0)
                or -(-h // sm.LAYER_TILE) * sm.LAYER_TILE)
        assert lib.sine_mlp_kernel_width(h) == want, h
        assert sm.kernel_width(h) == want, h
    assert lib.sine_mlp_kernel_width(0) == 0
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert sm.KERNEL_TILE_ROWS == {128: 128, 192: 64}
    for hidden, rows in sm.KERNEL_TILE_ROWS.items():
        assert lib.sine_mlp_tile_rows(hidden) == rows
        for n in (1, rows * 7 + 1, 512 * 512):
            grid, n_part, sizes = sm.partial_layout(n, 8, 2, hidden, 3, cuda_device)
            assert grid == min(-(-n // rows), sms)
            assert n_part % 4 == 0 and n_part >= sum(sizes)
            assert sizes[1] == 6 * hidden * hidden
    # above 192: the layer-wise kernels' 128-row tiles, one partial slice per row slice
    for hidden in (256, 384, 512, 640, 1024, 2048):
        assert lib.sine_mlp_tile_rows(hidden) == sm.LAYER_TILE
        for n in (1, 1000, 512 * 512):
            grid, n_part, sizes = sm.partial_layout(n, 8, 2, hidden, 3, cuda_device)
            assert grid == sm.layer_slices(n, hidden, sms)
            assert n_part % 4 == 0 and n_part >= sum(sizes)
            assert sizes[1] == 6 * hidden * hidden
    assert lib.sine_mlp_tile_rows(700) == 0  # not a kernel width


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_autograd_function_on_card_matches_cpu(cuda_device, precision):
    """siren_apply_flat on a CUDA tensor launches both kernels, and its
    output and gradients agree with the same call on the CPU (plain chain)."""
    m, c = build_model("siren", depth=4, hidden_size=64)
    cpu_params = m.init(torch.Generator().manual_seed(3), c)
    coords = torch.rand((3000, 2), generator=torch.Generator().manual_seed(4))
    target = torch.rand((3000, 3), generator=torch.Generator().manual_seed(5))
    results = []
    for dev in (torch.device("cpu"), cuda_device):
        params = tuple(
            {k: v.detach().clone().to(dev).requires_grad_(True) for k, v in layer.items()}
            for layer in cpu_params)
        before = dict(sm.LAUNCHES)
        out = m.apply_flat(params, coords.to(dev), c, precision)
        ((out - target.to(dev)) ** 2).mean().backward()
        launched = {k: sm.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({k: int(k in ("sine_mlp_fwd", "sine_mlp_bwd", "sum_partials"))
                             for k in before}
                            if dev.type == "cuda" else {k: 0 for k in before})
        results.append((out.detach().cpu(),
                        [layer[k].grad.cpu() for layer in params for k in KEYS]))
    (out_c, g_c), (out_g, g_g) = results
    tol = 1e-4 if precision == "fp32" else 3e-2
    assert float((out_c - out_g).abs().max()) <= tol
    for a, b in zip(g_g, g_c):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.cuda
def test_fit_on_card_matches_cpu(cuda_device):
    from implicit_image_tpu_torch.data import get_grid, synthetic_image
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

    m, c = build_model("siren", depth=4, hidden_size=32)
    init = m.init(torch.Generator().manual_seed(0), c)
    img = synthetic_image(32, 32, seed=0)
    tc = TrainConfig(num_steps=30, log_steps=10, matmul_precision="float32")
    psnr = [fit(None, m, c, get_grid(32, 32, dev), img, tc, OptimConfig(lr=1e-3),
                init_params=init, device=dev).metrics["psnr"]
            for dev in (torch.device("cpu"), cuda_device)]
    logged = psnr[0] == psnr[0]
    assert logged.sum() == 3
    assert abs(psnr[0][logged] - psnr[1][logged]).max() <= 0.05


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda_device):
    m, c = build_model("siren", depth=3, hidden_size=32)
    params = m.init(torch.Generator().manual_seed(0), c, cuda_device)
    with pytest.raises(ValueError):
        sm.sine_mlp_fwd(params, torch.zeros((8, 2)), c, "fp32")  # x on the CPU
    with pytest.raises(ValueError):
        sm.sine_mlp_fwd(params, torch.zeros((8, 2), device=cuda_device), c, "tf32")


def _small_fit_params(dev, depth=8, hidden=128, side=64, steps=20):
    from implicit_image_tpu_torch.data import get_grid, synthetic_image
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    img = synthetic_image(side, side, seed=1)
    res = fit(torch.Generator().manual_seed(0), m, c, get_grid(side, side, dev), img,
              TrainConfig(num_steps=steps, log_steps=steps), OptimConfig(), device=dev)
    return m, c, img, res


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [False, True])
def test_quant_finetune_repeats_bit_for_bit(cuda_device, delta):
    """Two codebook finetunes from the same params (d8 w128, 64^2 pixels),
    absolute or delta against an offset with row_stride 2: identical
    centroids, labels and quant PSNR."""
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.quant import QuantConfig
    from implicit_image_tpu_torch.training.fit import OptimConfig
    from implicit_image_tpu_torch.training.quant_phase import quant_finetune

    m, c, img, res = _small_fit_params(cuda_device)
    offsets = None
    if delta:
        offsets = m.init(torch.Generator().manual_seed(5), c, cuda_device)
    cfg = QuantConfig(num_steps=20, ecvq_lambda=1.0, row_stride=2 if delta else 1)
    runs = [quant_finetune(res.params, img, m, c, get_grid(64, 64, cuda_device), cfg,
                           OptimConfig(), offset_params=offsets)
            for _ in range(2)]
    assert runs[0].metrics["quant_psnr"] == runs[1].metrics["quant_psnr"]
    for a, b in zip(*(r.codebooks for r in runs)):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.centroids, b.centroids)
            assert torch.equal(a.labels, b.labels)


@pytest.mark.cuda
def test_ms_ssim_on_card_matches_cpu(cuda_device):
    from implicit_image_tpu_torch.ops.ssim import ms_ssim

    gen = torch.Generator().manual_seed(6)
    target = torch.rand((256, 256, 3), generator=gen)
    pred = (target + 0.02 * torch.randn((256, 256, 3), generator=gen)).clamp(0, 1)
    cpu = float(ms_ssim(pred, target, levels=5))
    card = float(ms_ssim(pred.to(cuda_device), target.to(cuda_device), levels=5))
    assert abs(card - cpu) <= 1e-5
    assert 0.0 < card <= 1.0


@pytest.mark.cuda
def test_rigl_fit_on_card_keeps_layer_counts(cuda_device, tmp_path):
    """40 RigL steps on the card from a saved mask, updating every 10 steps:
    each layer ends with its initial weight count, the topology moved, and
    every pruned weight is exactly 0."""
    import numpy as np

    from implicit_image_tpu_torch.data import get_grid, synthetic_image
    from implicit_image_tpu_torch.sparsity import MaskingConfig
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

    m, c = build_model("siren", depth=8, hidden_size=128)
    rng = np.random.default_rng(0)
    init = [(rng.uniform(size=dims) < 0.5).astype(np.float32) for dims in c.layer_dims]
    np.savez(tmp_path / "mask.npz", **{f"layers.{i}.mask": mk for i, mk in enumerate(init)})
    masking = MaskingConfig(sparse_init="lottery-ticket", mask_path=str(tmp_path / "mask.npz"),
                            interval=10, end_when=40)
    before = dict(sm.LAUNCHES)
    res = fit(torch.Generator().manual_seed(0), m, c, get_grid(64, 64, cuda_device),
              synthetic_image(64, 64, seed=2), TrainConfig(num_steps=40, log_steps=20),
              OptimConfig(), masking, device=cuda_device)
    assert sm.LAUNCHES["sine_mlp_bwd"] - before["sine_mlp_bwd"] == 40
    moved = False
    for mk, start, layer in zip(res.mask_state.masks, init, res.params):
        final = mk.cpu().numpy()
        assert final.sum() == start.sum()
        moved |= bool((final != start).any())
        assert torch.all(layer["w"][mk == 0] == 0.0)
    assert moved
    assert np.isfinite(res.metrics["psnr"][-1])


@pytest.mark.cuda
def test_coordx_on_card_matches_cpu(cuda_device):
    """CoordX has no kernel of its own: its fp32 torch.matmul forward and
    gradients on the card agree with the CPU's at the flagship widths, and
    a CUDA forward with 1-pass TF32 switched on raises."""
    m, c = build_model("coordx", depth=8, hidden_size=96, split_depth=5)
    params = m.init(torch.Generator().manual_seed(3), c)
    target = torch.rand((64, 64, 3), generator=torch.Generator().manual_seed(4))
    results = []
    for dev in ("cpu", cuda_device):
        p = tuple({k: v.detach().to(dev, copy=True).requires_grad_(True)
                   for k, v in layer.items()} for layer in params)
        out = m.apply(p, get_grid(64, 64, dev), c)
        ((out - target.to(dev)) ** 2).mean().backward()
        results.append((out.detach().cpu(), [{k: layer[k].grad.cpu() for k in KEYS}
                                             for layer in p]))
    (out_c, g_c), (out_g, g_g) = results
    assert float((out_g - out_c).abs().max()) <= 1e-5
    for a, b in zip(g_g, g_c):
        for k in KEYS:
            assert float((a[k] - b[k]).abs().max()) <= 1e-4 * float(b[k].abs().max())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            m.apply(tuple({k: v.to(cuda_device) for k, v in layer.items()} for layer in params),
                    get_grid(8, 8, cuda_device), c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _card_vs_cpu(m, c, params, grid_hw, cuda_device, seed=4):
    """(launches on the card, CPU (out, grads), card (out, grads)) of one
    forward + backward through m.apply on both devices."""
    target = torch.rand(grid_hw + (3,), generator=torch.Generator().manual_seed(seed))
    results, launched = [], None
    for dev in (torch.device("cpu"), cuda_device):
        p = tuple({k: v.detach().to(dev, copy=True).requires_grad_(k in KEYS)
                   for k, v in layer.items()} for layer in params)
        before = dict(sm.LAUNCHES)
        out = m.apply(p, get_grid(*grid_hw, dev), c)
        ((out - target.to(dev)) ** 2).mean().backward()
        torch.cuda.synchronize()
        if dev.type == "cuda":
            launched = {k: sm.LAUNCHES[k] - before[k] for k in before}
        results.append((out.detach().cpu(), [layer[k].grad.cpu() for layer in p
                                             for k in KEYS if k in layer]))
    return launched, results[0], results[1]


def _assert_close(cpu, card, fwd_tol, rel_tol):
    (out_c, g_c), (out_g, g_g) = cpu, card
    assert float((out_g - out_c).abs().max()) <= fwd_tol
    for a, b in zip(g_g, g_c):
        assert float((a - b).abs().max()) <= rel_tol * float(b.abs().max())


@pytest.mark.cuda
def test_wavelet_siren_on_card_launches_twice_and_matches_cpu(cuda_device):
    """Both sub-SIRENs of a wavelet-SIREN run on the kernels: one forward and
    backward launch K1, K2 and sum_partials twice each, on a 34 x 34 DWT
    lattice (1,156 rows, no whole number of tiles), and agree with the CPU;
    with 1-pass TF32 products switched on the inverse DWT raises."""
    m, c = build_model("wavelet_siren", depth=4, hidden_size=32, height=64, width=64)
    params = m.init(torch.Generator().manual_seed(3), c)
    launched, cpu, card = _card_vs_cpu(m, c, params, (64, 64), cuda_device)
    assert launched == {k: 2 * (k in ("sine_mlp_fwd", "sine_mlp_bwd", "sum_partials"))
                        for k in sm.LAUNCHES}
    _assert_close(cpu, card, 1e-4, 1e-4)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            m.apply(tuple({k: v.to(cuda_device) for k, v in layer.items()} for layer in params),
                    get_grid(64, 64, cuda_device), c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_wavelet_siren_fit_repeats_bit_for_bit(cuda_device):
    """Two 20-step wavelet-SIREN fits on the card from one init end on the
    same bits: the DWT products and the kernels add in a fixed order."""
    from implicit_image_tpu_torch.data import synthetic_image
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

    m, c = build_model("wavelet_siren", depth=4, hidden_size=64, height=128, width=96)
    init = m.init(torch.Generator().manual_seed(0), c)
    img = synthetic_image(128, 96, seed=0)
    runs = [fit(None, m, c, get_grid(128, 96, cuda_device), img,
                TrainConfig(num_steps=20, log_steps=10), OptimConfig(lr=1e-3),
                init_params=init, device=cuda_device).params for _ in range(2)]
    for a, b in zip(*runs):
        for k in KEYS:
            assert torch.equal(a[k], b[k])


@pytest.mark.cuda
def test_feathermap_siren_on_card_launches_kernels_and_matches_cpu(cuda_device):
    """Feathermap over SIREN: the materialized weights go through K1/K2 once
    each, and the gradients into V1, V2 and the scalers agree with the CPU."""
    from implicit_image_tpu_torch.models import build_model_from_config

    m, c = build_model_from_config({"mlp": {"name": "siren", "depth": 4, "hidden_size": 32},
                                    "masking": {"name": "Feathermap", "density": 0.2}})
    params = m.init(torch.Generator().manual_seed(3), c)
    launched, cpu, card = _card_vs_cpu(m, c, params, (32, 32), cuda_device)
    assert launched == {k: int(k in ("sine_mlp_fwd", "sine_mlp_bwd", "sum_partials"))
                        for k in sm.LAUNCHES}
    assert len(card[1]) == 3
    _assert_close(cpu, card, 1e-4, 1e-4)


@pytest.mark.cuda
def test_fourier_on_card_runs_no_kernel_and_matches_cpu(cuda_device):
    m, c = build_model("fourier", depth=8, hidden_size=128)
    params = m.init(torch.Generator().manual_seed(3), c)
    launched, cpu, card = _card_vs_cpu(m, c, params, (64, 64), cuda_device)
    assert launched == {k: 0 for k in sm.LAUNCHES}
    _assert_close(cpu, card, 1e-5, 1e-4)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            m.apply(tuple({k: v.to(cuda_device) for k, v in layer.items()} for layer in params),
                    get_grid(8, 8, cuda_device), c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_schedule_launch_modes_on_card(cuda_device):
    """K1/K2/sum_partials launch in the bf16 mode for the steps before the
    switch (0.75 of 20) and their evals, in fp32 after."""
    import numpy as np

    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

    m, c = build_model("siren", depth=4, hidden_size=32)
    img = np.random.default_rng(0).uniform(size=(32, 32, 3)).astype(np.float32)
    sm.reset_launch_counts()
    fit(torch.Generator().manual_seed(0), m, c, get_grid(32, 32, cuda_device), img,
        TrainConfig(num_steps=20, log_steps=5, matmul_precision_early="bfloat16"),
        OptimConfig(), device=cuda_device)
    assert sm.LAUNCHES_BY_MODE["sine_mlp_fwd"] == {"bf16": 15 + 3, "fp32": 5 + 1}
    assert sm.LAUNCHES_BY_MODE["sine_mlp_bwd"] == {"bf16": 15, "fp32": 5}
    assert sm.LAUNCHES_BY_MODE["sum_partials"] == {"bf16": 15, "fp32": 5}
    assert sm.LAUNCHES["sine_mlp_fwd"] == 24


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("depth,hidden,n", [(5, 32, 4099), (8, 128, 40000), (8, 182, 20000),
                                            (3, 512, 5000), (2, 192, 700)])
def test_mixed_kernels_match_the_plain_chain(cuda_device, mode, depth, hidden, n):
    """The kernels under "+mixed" against the plain chain, within the bf16
    mode's limits (1.5e-3 forward, 2e-2 of the largest gradient)."""
    prec = mode + sm.MIXED
    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    params = m.init(torch.Generator().manual_seed(0), c, cuda_device)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand((n, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((n, 3), generator=gen).to(cuda_device)
    sm.reset_launch_counts()
    out = sm.sine_mlp_fwd(params, x, c, prec)
    _, grads = sm.sine_mlp_bwd(params, x, g, c, prec)
    if sm.kernel_width(hidden) > sm.KERNEL_WIDTHS[-1]:  # the forward's layers, K2's recompute
        assert sm.LAUNCHES_BY_MODE["sine_mlp_layer_fwd"][mode] == 2 * depth - 1
    else:
        assert sm.LAUNCHES_BY_MODE["sine_mlp_fwd"][mode] == 1
    assert float((out - sm.siren_chain_reference(params, x, c, prec)).abs().max()) <= 1.5e-3
    _, ref = sm.siren_chain_backward_reference(params, x, g, c, prec)
    for a, b in zip(grads, ref):
        for k in KEYS:
            assert float((a[k] - b[k]).abs().max()) <= 2e-2 * float(b[k].abs().max())
            # dW and db come out as bf16 values
            assert torch.equal(a[k], a[k].to(torch.bfloat16).float())
    # mixed is not the plain mode: the activations round
    plain = sm.sine_mlp_fwd(params, x, c, mode)
    assert not torch.equal(out, plain) or mode == "bf16"


@pytest.mark.cuda
def test_resume_on_card_is_bit_exact(cuda_device, tmp_path):
    """A RigL fit resumed from its step-6 checkpoint ends with the bits of
    the uninterrupted 12-step fit (K2 adds in a fixed order)."""
    import shutil

    import numpy as np

    from implicit_image_tpu_torch.sparsity import MaskingConfig
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

    m, c = build_model("siren", depth=5, hidden_size=64)
    img = np.random.default_rng(2).uniform(size=(48, 48, 3)).astype(np.float32)
    ck = tmp_path / "ck.npz"

    def watch(params, opt_state, step):
        if step == 6:
            shutil.copy(ck, tmp_path / "at6.npz")

    def run(**kw):
        return fit(torch.Generator().manual_seed(0), m, c, get_grid(48, 48, cuda_device), img,
                   TrainConfig(num_steps=12, log_steps=6, segment_steps=6), OptimConfig(lr=1e-3),
                   MaskingConfig(density=0.5, interval=4, end_when=10), device=cuda_device, **kw)

    full = run(checkpoint_path=ck, watch=watch)
    rest = run(resume_from=tmp_path / "at6.npz")
    for a, b in zip(full.params, rest.params):
        for k in a:
            assert torch.equal(a[k], b[k])
    for a, b in zip(full.mask_state.masks, rest.mask_state.masks):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_hashgrid_fit_on_card_repeats_and_matches_cpu(cuda_device):
    """Two hashgrid fits on the card give the same bits (the hashed levels'
    transpose-gather backward has no atomics), launch no SIREN kernel, and
    end near the CPU's fit."""
    import numpy as np

    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

    m, c = build_model("hashgrid", n_levels=6, log2_table_size=10, base_resolution=8,
                       finest_resolution=128)
    img = np.random.default_rng(3).uniform(size=(64, 64, 3)).astype(np.float32)

    def run(dev):
        return fit(torch.Generator().manual_seed(0), m, c, get_grid(64, 64, dev), img,
                   TrainConfig(num_steps=20, log_steps=20), OptimConfig(lr=1e-2), device=dev)

    sm.reset_launch_counts()
    a, b = run(cuda_device), run(cuda_device)
    assert not any(sm.LAUNCHES.values())
    for la, lb in zip(a.params, b.params):
        for k in la:
            assert torch.equal(la[k], lb[k])
    cpu = run(torch.device("cpu"))
    assert abs(float(a.metrics["psnr"][-1]) - float(cpu.metrics["psnr"][-1])) <= 0.05


@pytest.mark.cuda
def test_exact_sine_and_coordx_bf16_on_card_match_cpu(cuda_device):
    """mlp.fast_sine=false (the torch.sin chain) launches no kernel, and it
    and CoordX at "bf16" and "+mixed" agree with the CPU (fp32 1e-5; the
    bf16 modes at the kernels' bf16 forward limit, 1.5e-3: an operand that
    lies at a bf16 rounding boundary may round the other way)."""
    for name, kw, prec, tol in (("siren", dict(depth=4, hidden_size=32, fast_sine=False),
                                 "fp32", 1e-5),
                                ("coordx", dict(depth=5, hidden_size=16, split_depth=2),
                                 "bf16", 1.5e-3),
                                ("coordx", dict(depth=5, hidden_size=16, split_depth=2),
                                 "fp32" + sm.MIXED, 1.5e-3)):
        m, c = build_model(name, **kw)
        params = m.init(torch.Generator().manual_seed(0), c)
        grid = get_grid(24, 20)
        sm.reset_launch_counts()
        card = m.apply(tuple({k: v.to(cuda_device) for k, v in layer.items()} for layer in params),
                       grid.to(cuda_device), c, prec).cpu()
        assert not any(sm.LAUNCHES.values())
        cpu = m.apply(params, grid, c, prec)
        assert float((card - cpu).abs().max()) <= tol, (name, prec)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("depth,hidden,n", [(8, 128, 4099), (2, 64, 300), (8, 182, 3001),
                                            (4, 256, 2000), (3, 512, 1000), (2, 192, 500)])
def test_batched_forward_is_single_launches_bit_for_bit(cuda_device, precision, depth, hidden,
                                                        n):
    """K1 over a member axis: one launch, each member the bits of its own
    single launch, with one shared x and with one x per member, in every
    mode ("+mixed" too); within the forward's limits of the plain version
    (the bf16 mode's for "+mixed")."""
    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    gen = torch.Generator().manual_seed(3)
    members = [m.init(gen, c, cuda_device) for _ in range(3)]
    x = (torch.rand((n, 2), generator=gen) * 2 - 1).to(cuda_device)
    xs = (torch.rand((3, n, 2), generator=gen) * 2 - 1).to(cuda_device)
    before = dict(sm.LAUNCHES)
    shared = sm.sine_mlp_fwd_batched(members, x, c, precision)
    per = sm.sine_mlp_fwd_batched(members, xs, c, precision)
    torch.cuda.synchronize()
    if sm.kernel_width(hidden) > sm.KERNEL_WIDTHS[-1]:  # above 192: the layer-wise kernels
        assert _layer_launches(before, depth, fwd_calls=2, batched=True)
    else:
        assert sm.LAUNCHES["sine_mlp_fwd_batched"] == before["sine_mlp_fwd_batched"] + 2
        assert sm.LAUNCHES["sine_mlp_fwd"] == before["sine_mlp_fwd"]
    for i, p in enumerate(members):
        assert torch.equal(shared[i], sm.sine_mlp_fwd(p, x, c, precision))
        assert torch.equal(per[i], sm.sine_mlp_fwd(p, xs[i].clone(), c, precision))
    ref = sm.siren_chain_reference_batched(members, x, c, precision)
    assert float((shared - ref).abs().max()) <= (1e-4 if precision == "fp32" else 1.5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("depth,hidden,n", [(8, 182, 20000), (3, 192, 4099)])
def test_w192_forward_repeats_bit_for_bit(cuda_device, precision, depth, hidden, n):
    """K1 at kernel width 192 (the wgmma forward, 128-row tiles) repeats bit
    for bit in every mode, one launch a call, within the forward's limits of
    the plain chain (the bf16 mode's for "+mixed")."""
    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    params = m.init(torch.Generator().manual_seed(4), c, cuda_device)
    x = (torch.rand((n, 2), generator=torch.Generator().manual_seed(6)) * 2 - 1).to(cuda_device)
    before = sm.LAUNCHES["sine_mlp_fwd"]
    first = sm.sine_mlp_fwd(params, x, c, precision)
    second = sm.sine_mlp_fwd(params, x, c, precision)
    torch.cuda.synchronize()
    assert sm.LAUNCHES["sine_mlp_fwd"] == before + 2
    assert torch.equal(first, second)
    ref = sm.siren_chain_reference(params, x, c, precision)
    assert float((first - ref).abs().max()) <= (1e-4 if precision == "fp32" else 1.5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
def test_w182_planes_packed_once_per_pair_under_autograd(cuda_device, monkeypatch, precision):
    """Under autograd at w182 (kernel width 192) K1 packs W's planes and K2
    takes them: one weight_planes call per K1/K2 pair, and K2's dx, dW and db
    the bits of sine_mlp_bwd, which packs its own, on the same inputs."""
    m, c = build_model("siren", depth=8, hidden_size=182)
    params = m.init(torch.Generator().manual_seed(7), c, cuda_device)
    gen = torch.Generator().manual_seed(8)
    x = (torch.rand((5000, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((5000, 3), generator=gen).to(cuda_device)
    dx_want, grads_want = sm.sine_mlp_bwd(params, x, g, c, precision)
    calls = []
    packer = sm.weight_planes
    monkeypatch.setattr(sm, "weight_planes", lambda *a: calls.append(a) or packer(*a))
    leaves = [{k: layer[k].detach().clone().requires_grad_(True) for k in KEYS}
              for layer in params]
    xg = x.clone().requires_grad_(True)
    flat = [t for layer in leaves for t in (layer["w"], layer["b"])]
    out = sm.SineMLPFunction.apply(xg, c, precision, False, *flat)
    out.backward(g)
    torch.cuda.synchronize()
    assert len(calls) == 1
    assert torch.equal(xg.grad, dx_want)
    for got, want in zip(leaves, grads_want):
        for k in KEYS:
            assert torch.equal(got[k].grad, want[k])


@pytest.mark.cuda
def test_fwd_w192_refuses_null_or_misaligned_planes(cuda_device):
    """The width-192 forward's launcher (and the C entry that routes width
    192 to it) returns cudaErrorInvalidValue for W's planes null or not
    16-byte aligned, and launches nothing."""
    import ctypes

    lib = sm._lib()
    m, c = build_model("siren", depth=4, hidden_size=182)
    params = m.init(torch.Generator().manual_seed(9), c, cuda_device)
    x = (torch.rand((300, 2), generator=torch.Generator().manual_seed(10)) * 2 - 1).to(
        cuda_device)
    w0, wm, wl, bs, bl = sm._pack(params, 192)
    planes = sm.weight_planes(wm, 3)
    out = torch.full((300, 3), 7.0, device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    fn = lib.sine_mlp_fwd_w192
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 8 + [I] * 4 + [F, F] + [I] * 3 + [ctypes.c_longlong, P]
    fn.restype = I
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    om = sm._omegas(c, 4)
    invalid = 1  # cudaErrorInvalidValue
    for wp in (None, planes.data_ptr() + 4):
        assert fn(x.data_ptr(), w0.data_ptr(), wm.data_ptr(), wp, wl.data_ptr(), bs.data_ptr(),
                  bl.data_ptr(), out.data_ptr(), 300, 2, 3, 4, om[0], om[1], 0, sms, 1, 0,
                  stream) == invalid
        assert lib.sine_mlp_fwd_batched(x.data_ptr(), w0.data_ptr(), wm.data_ptr(), wp,
                                        wl.data_ptr(), bs.data_ptr(), bl.data_ptr(),
                                        out.data_ptr(), 1, 0, 300, 2, 3, 4, 192, om[0], om[1], 0,
                                        stream) == invalid
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    assert fn(x.data_ptr(), w0.data_ptr(), wm.data_ptr(), planes.data_ptr(), wl.data_ptr(),
              bs.data_ptr(), bl.data_ptr(), out.data_ptr(), 300, 2, 3, 4, om[0], om[1], 0, sms, 1,
              0, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, sm.sine_mlp_fwd(params, x, c, "fp32"))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("depth,hidden,n", [(8, 128, 4099), (2, 64, 300), (8, 182, 3001),
                                            (4, 256, 2000), (3, 512, 1000), (2, 192, 500)])
def test_batched_backward_is_single_launches_bit_for_bit(cuda_device, precision, depth, hidden,
                                                         n):
    """K2 over a member axis (M = 3) at every kernel width, in every mode
    ("+mixed" too, within the bf16 mode's limits): one launch each of the
    backward and of the partial sum (above 192 the layer-wise kernels'
    launches over the member axis), each member's dx, dW and db the bits of
    its own single launch, with one shared x and with one x per member;
    within the single backward's limits of the plain version."""
    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    gen = torch.Generator().manual_seed(5)
    members = [m.init(gen, c, cuda_device) for _ in range(3)]
    x = (torch.rand((n, 2), generator=gen) * 2 - 1).to(cuda_device)
    xs = (torch.rand((3, n, 2), generator=gen) * 2 - 1).to(cuda_device)
    g = torch.randn((3, n, 3), generator=gen).to(cuda_device)
    before = dict(sm.LAUNCHES)
    shared = sm.sine_mlp_bwd_batched(members, x, g, c, precision)
    per = sm.sine_mlp_bwd_batched(members, xs, g, c, precision)
    torch.cuda.synchronize()
    if sm.kernel_width(hidden) > sm.KERNEL_WIDTHS[-1]:  # above 192: the layer-wise kernels
        assert _layer_launches(before, depth, bwd_calls=2, batched=True)
    else:
        launched = {k: sm.LAUNCHES[k] - before[k] for k in before}
        assert launched == {k: 2 * (k in ("sine_mlp_bwd_batched", "sum_partials_batched"))
                            for k in before}
    for (dx, grads), xm in ((shared, [x] * 3), (per, [t.clone() for t in xs])):
        for i, p in enumerate(members):
            dx_1, grads_1 = sm.sine_mlp_bwd(p, xm[i], g[i].clone(), c, precision)
            assert torch.equal(dx[i], dx_1)
            for a, b in zip(grads, grads_1):
                for k in KEYS:
                    assert torch.equal(a[k][i], b[k]), (i, k)
    dx_r, grads_r = sm.siren_chain_backward_reference_batched(members, x, g, c, precision)
    tol = 1e-4 if precision == "fp32" else 2e-2
    for a, b in [(shared[0], dx_r)] + [(a[k], b[k]) for a, b in zip(shared[1], grads_r)
                                       for k in KEYS]:
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,members,n", [(512, 2, 1 << 22), (182, 1200, 1 << 18)])
def test_batched_backward_too_large_raises_before_allocating(cuda_device, hidden, members, n):
    """Members whose buffers exceed the card's free memory raise ValueError
    before the launch's buffers are allocated; nothing falls back to single
    launches. At w512, d8, 2^22 rows (the layer-wise kernels): ~60 GB of z
    stash each (its recompute), and two N x 512 buffers. At w182
    (kernel width 192), whose backward sums dW itself, a member's buffers at
    512^2 are its z stash and partials (~0.14 GB): 1,200 members need ~170
    GB, more than the card holds."""
    m, c = build_model("siren", depth=8, hidden_size=hidden)
    gen = torch.Generator().manual_seed(6)
    one = m.init(gen, c, cuda_device)
    stacked = tuple({k: v.expand((members,) + v.shape).contiguous() for k, v in layer.items()}
                    for layer in one) if members > 2 else [one, m.init(gen, c, cuda_device)]
    x = torch.zeros((n, 2), device=cuda_device)
    g = torch.zeros((members, n, 3), device=cuda_device)
    torch.cuda.synchronize()
    before, allocated = dict(sm.LAUNCHES), torch.cuda.memory_allocated()
    with pytest.raises(ValueError, match="fit fewer members"):
        sm.sine_mlp_bwd_batched(stacked, x, g, c, "fp32")
    assert sm.LAUNCHES == before
    assert torch.cuda.memory_allocated() - allocated < 64 << 20


@pytest.mark.cuda
@pytest.mark.parametrize("masking", [None, "RigL"])
def test_batched_fit_is_single_fits_bit_for_bit(cuda_device, masking):
    """batched_fit on the card: each member's params, masks and metrics the
    bits of a single fit with its generator, and each step one K1 and one K2
    launch over the member axis (no single launch)."""
    import numpy as np

    from implicit_image_tpu_torch.data import synthetic_image
    from implicit_image_tpu_torch.parallel.batched import batched_fit, member_generators
    from implicit_image_tpu_torch.sparsity import MaskingConfig
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

    m, c = build_model("siren", depth=4, hidden_size=32)
    grid = get_grid(32, 32, cuda_device)
    imgs = np.stack([synthetic_image(32, 32, seed=s) for s in range(3)])
    tc, oc = TrainConfig(num_steps=30, log_steps=10), OptimConfig(lr=1e-3)
    mk = MaskingConfig(density=0.5, end_when=20, interval=5) if masking else None
    sm.reset_launch_counts()
    res = batched_fit(torch.Generator().manual_seed(2), m, c, grid, imgs, tc, oc, mk)
    launched = dict(sm.LAUNCHES)
    assert launched["sine_mlp_bwd_batched"] == 30 and launched["sum_partials_batched"] == 30
    assert launched["sine_mlp_fwd_batched"] == 30 + 3  # the steps and the evals
    assert launched["sine_mlp_bwd"] == launched["sine_mlp_fwd"] == 0
    gens = member_generators(torch.Generator().manual_seed(2), 3)
    for i in range(3):
        single = fit(gens[i], m, c, grid, imgs[i], tc, oc, mk)
        for a, b in zip(res.params, single.params):
            for k in KEYS:
                assert torch.equal(a[k][i], b[k]), (i, k)
        for k, v in single.metrics.items():
            assert np.array_equal(res.metrics[k][i], v, equal_nan=True), (i, k)
        if mk is not None:
            for a, b in zip(res.mask_state.masks, single.mask_state.masks):
                assert torch.equal(a[i], b)


@pytest.mark.cuda
def test_max_rows_is_the_library_limit(cuda_device):
    """The wrappers' row guard is the kernels' own limit (kMaxRows)."""
    assert sm._lib().sine_mlp_max_rows() == sm.MAX_ROWS


@pytest.mark.cuda
def test_region_renders_are_the_full_render_slice_on_card(cuda_device):
    """Windows and row bands launch K1 on their own rows only, and equal the
    full render's slice bit for bit."""
    from implicit_image_tpu_torch.coding import render_region

    m, c = build_model("siren", depth=8, hidden_size=128)
    params = m.init(torch.Generator().manual_seed(4), c, cuda_device)
    full = render_region(m, c, params, 300, 260)
    assert (full == render_region(m, c, params, 300, 260, tile_rows=37)).all()
    roi = (17, 290, 3, 251)
    win = render_region(m, c, params, 300, 260, roi=roi, tile_rows=64)
    assert (win == full[17:290, 3:251]).all()


@pytest.mark.cuda
def test_base_finetune_repeats_bit_for_bit_on_card(cuda_device):
    import numpy as np

    from implicit_image_tpu_torch.coding import linear_state_dict
    from implicit_image_tpu_torch.coding.progressive import _split_entries
    from implicit_image_tpu_torch.quant import QuantConfig, convert
    from implicit_image_tpu_torch.quant.base_layer import finetune_base_codebooks

    m, c = build_model("siren", depth=5, hidden_size=64)
    params = m.init(torch.Generator().manual_seed(5), c, cuda_device)
    snapped, books = convert(params, QuantConfig(bits=8))
    base, _ = _split_entries(linear_state_dict(snapped, books, half="auto"))
    img = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
    grid = get_grid(64, 64, cuda_device)
    runs = [finetune_base_codebooks(m, c, grid, img, base, steps=10) for _ in range(2)]
    assert runs[0].keys() == runs[1].keys() and len(runs[0]) == 3
    for k in runs[0]:
        assert np.array_equal(runs[0][k], runs[1][k])


# the compress CLI's last options (QAT, Shampoo, EKFAC; Fourier and
# Feathermap beyond fp32) on the card


@pytest.mark.cuda
@pytest.mark.parametrize("qscheme", ["per_channel", "per_tensor"])
def test_qat_finetune_on_card(cuda_device, qscheme):
    """The QAT finetune under RigL masks on the card: K2 once per STE step
    and K1 once more for its eval, the same bits twice, pruned weights
    exactly 0, and codes that agree with the CPU's plain chain but where a
    latent weight lies at a half-way point (at most 1% of them, by one)."""
    import numpy as np

    from implicit_image_tpu_torch.quant import QuantConfig
    from implicit_image_tpu_torch.training.fit import OptimConfig
    from implicit_image_tpu_torch.training.quant_phase import quant_finetune

    m, c = build_model("siren", depth=5, hidden_size=64)
    params = m.init(torch.Generator().manual_seed(4), c)
    gen = torch.Generator().manual_seed(5)
    masks = [None] + [(torch.rand(layer["w"].shape, generator=gen) < 0.5).float()
                      for layer in params[1:-1]] + [None]
    params = tuple({**layer, "w": layer["w"] * mk} if mk is not None else layer
                   for layer, mk in zip(params, masks))
    img = np.random.default_rng(6).random((48, 48, 3)).astype(np.float32)
    qcfg = QuantConfig(name="QAT", qscheme=qscheme, num_steps=6)

    def run(dev):
        return quant_finetune(tuple({k: v.to(dev) for k, v in layer.items()} for layer in params),
                              img, m, c, get_grid(48, 48, dev), qcfg, OptimConfig(lr=1e-4),
                              precision="fp32",
                              masks=[None if mk is None else mk.to(dev) for mk in masks])

    sm.reset_launch_counts()
    a = run(cuda_device)
    assert sm.LAUNCHES["sine_mlp_bwd"] == sm.LAUNCHES["sum_partials"] == 6
    assert sm.LAUNCHES["sine_mlp_fwd"] == 7
    b, cpu = run(cuda_device), run(torch.device("cpu"))
    for i, (ba, bb, bc) in enumerate(zip(a.codebooks, b.codebooks, cpu.codebooks)):
        if ba is None:
            continue
        codes = [(x.codes if qscheme == "per_channel" else x.labels).cpu().long()
                 for x in (ba, bb, bc)]
        assert torch.equal(codes[0], codes[1])
        diff = codes[0] != codes[2]
        assert diff.float().mean() <= 0.01 and ((codes[0] - codes[2])[diff].abs() <= 1).all()
        pruned = masks[i] == 0
        assert not a.params[i]["w"].cpu()[pruned].any()


@pytest.mark.cuda
def test_shampoo_and_ekfac_fits_on_card(cuda_device):
    """A Shampoo fit and an EKFAC fit on the card each give the same bits
    twice and end near the CPU's (0.1 dB: the kernels' fp32 mode against
    the plain chain, through eigendecompositions by cuSOLVER and LAPACK)."""
    import numpy as np

    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

    m, c = build_model("siren", depth=4, hidden_size=32)
    img = np.random.default_rng(7).random((32, 32, 3)).astype(np.float32)
    for ocfg in (OptimConfig(name="shampoo", lr=0.1, epsilon=0.1),
                 OptimConfig(lr=1e-3, preconditioner="ekfac", precond_interval=4)):
        def run(dev):
            return fit(torch.Generator().manual_seed(0), m, c, get_grid(32, 32, dev), img,
                       TrainConfig(num_steps=10, log_steps=10), ocfg, device=dev)

        a, b, cpu = run(cuda_device), run(cuda_device), run(torch.device("cpu"))
        for la, lb in zip(a.params, b.params):
            for k in la:
                assert torch.equal(la[k], lb[k]), ocfg
        assert abs(float(a.metrics["psnr"][-1]) - float(cpu.metrics["psnr"][-1])) <= 0.1, ocfg


@pytest.mark.cuda
def test_shampoo_and_ekfac_refuse_tf32(cuda_device):
    """Their Gram products must be true fp32 on the card: with TF32 on, the
    update and the capture raise."""
    from implicit_image_tpu_torch.optim.ekfac import capture_layer_stats
    from implicit_image_tpu_torch.optim.shampoo import shampoo_init, shampoo_update

    m, c = build_model("siren", depth=3, hidden_size=16)
    params = m.init(torch.Generator().manual_seed(0), c, cuda_device)
    grads = tuple({k: torch.ones_like(v) for k, v in layer.items()} for layer in params)
    coords = get_grid(8, 8, cuda_device).reshape(-1, 2)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="fp32"):
            shampoo_update(grads, shampoo_init(params), params, 0.1)
        with pytest.raises(RuntimeError, match="fp32"):
            capture_layer_stats(m, c, params, coords, torch.zeros(64, 3, device=cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_fourier_and_feathermap_bf16_on_card_match_cpu(cuda_device):
    """Fourier (no kernel) at "bf16" and "+mixed", and Feathermap over
    SIREN at "bf16" (V1 @ V2 in one bf16 pass, then the bf16 kernels),
    agree with the CPU within the kernels' bf16 forward limit, 1.5e-3."""
    from implicit_image_tpu_torch.feathermap import build_feather_model

    fm_base, fc = build_model("siren", depth=4, hidden_size=32)
    cases = (("fourier", *build_model("fourier", depth=4, hidden_size=32, map_size=32)),
             ("feathermap", build_feather_model(fm_base, fc, 0.5), fc))
    for name, m, c in cases:
        params = m.init(torch.Generator().manual_seed(0), c)
        grid = get_grid(24, 20)
        for prec in ("bf16", "fp32" + sm.MIXED):
            sm.reset_launch_counts()
            card = m.apply(tuple({k: v.to(cuda_device) for k, v in layer.items()}
                                 for layer in params), grid.to(cuda_device), c, prec).cpu()
            assert any(sm.LAUNCHES.values()) == (name == "feathermap"), (name, prec)
            cpu = m.apply(params, grid, c, prec)
            assert float((card - cpu).abs().max()) <= 1.5e-3, (name, prec)


@pytest.mark.cuda
def test_sequence_decode_is_the_encode_sides_render_on_card(cuda_device, tmp_path):
    """encode_sequence at 64² d4 (RigL 0.5, an I-frame every 3 of 5 frames)
    on K1/K2: decode_sequence gives every frame the bits of the encode
    side's render, a GOP seek the full decode's frame, and a P-frame keeps
    every weight its previous frame pruned at 0 (a P-fit's topology is
    frozen; a kept weight may still decode to 0 where its residual
    centroid cancels its offset exactly)."""
    import numpy as np

    from implicit_image_tpu_torch.coding import decompress_state_dict
    from implicit_image_tpu_torch.sequence import decode_sequence, encode_sequence

    renders = {}
    sm.reset_launch_counts()
    rows = encode_sequence(["img=synthetic", "img.height=64", "img.width=64", "mlp.depth=4",
                            "mlp.hidden_size=32", "train.num_steps=40", "train.log_steps=20",
                            "quant=kmeans", "quant.num_steps=5", "entropy_coding=zstd",
                            "sequence.video=card", "sequence.frames=5", "sequence.gop=3",
                            "sequence.steps=10", "sequence.max_drop=none",
                            f"output_dir={tmp_path}"], device="cuda", renders=renders)
    assert [r["kind"] for r in rows] == ["I", "P", "P", "I", "P"]
    assert sm.LAUNCHES["sine_mlp_fwd"] > 0 and sm.LAUNCHES["sine_mlp_bwd"] > 0
    root = tmp_path / "seq_card"
    frames, names = decode_sequence(root, device="cuda")
    for t, name in enumerate(names):
        assert np.array_equal(frames[t], renders[name]), name
    for t in (2, 4):
        img, _ = decode_sequence(root, frame=t, device="cuda")
        assert np.array_equal(img, frames[t])
    states = []
    for name in names:
        states.append(decompress_state_dict(root / name / "model_quantized", "zstd",
                                            prev_state=states[-1] if states else None))
    for t in (1, 2, 4):
        for i in (1, 2):
            prev, cur = (s[f"layers.{i}.weight"] for s in (states[t - 1], states[t]))
            assert (prev == 0).any() and not ((prev == 0) & (cur != 0)).any(), (t, i)
