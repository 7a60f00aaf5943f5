"""Where the layer-wise kernels' time goes, on the card.

    python -m implicit_image_tpu_torch.tools.layer_knockouts [--widths 640 1024]
        [--out FILE]

Builds copies of the layer-wise forward, backward and dW parts of
csrc/sine_mlp.cu (-DSINE_MLP_LAYER=0, 1 and 2, one nvcc each, all at once)
with one part knocked out each (their results are wrong by design), and
times one launch of each kind of `sine_mlp_layer_fwd` (first, hidden,
last) and of `sine_mlp_layer_bwd` (hidden, last, first) and one
`sine_mlp_layer_dw` launch of each at 512^2 rows (in = 2, out = 3; the
forward's first layer with the stash, as under autograd) and every width
of --widths, in the fp32 and bf16 modes (CUDA events over 10 launches after
a warm-up; each variant's launches in turns with the others', two rounds,
the second kept):

  no_mma      the products (every wgmma pass of each kernel)
  no_split    the forward: the consumers' split of the activations into
              planes (the fp32 bits as the one plane)
  no_epi      the forward: the epilogue (z's stash, the sine and a's
              stores); the backward: its epilogue (gz, G's and A's stores,
              db's column sums; z is still copied in)
  no_feed     the backward: the feeding thread's copies (each stage's and
              z's mbarrier completes at once, the products and the epilogue
              read what the buffers hold)
  no_gsplit   dW: the feeding warpgroups' split of G into planes
  no_asplit   dW: the consumers' split of A into planes
  no_fring    the forward's first layer: the feeding warp's loads of x's
              rows (each stage's mbarrier completes at once)
  no_fstore   the forward's first layer: its stores of z_0 and a_0
  no_lring    the backward's last layer: the feeding warp's tensor copies
              of z_L's tiles (its lanes still stage g's rows)
  no_lstore   the backward's last layer: its stores of G_L

The differences to "full" say what each part costs. Prints a line per
kernel, width and mode, and writes the record, with the card's name and
power limit, as JSON to --out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from implicit_image_tpu_torch.ops import cuda_build as cb
from implicit_image_tpu_torch.ops import sine_mlp as sm

PASS0 = "  wg_passes<PA, PB, 1, 1>(d, a0, 0, b0, plane, first);"
PASS1 = "  wg_passes<PA, PB, 1, 1>(d, a1, 0, b0 + 4096, plane, false);"
FWD_SPLIT = "    iit::split_planes<NP>(v.x, v.y, pl);"
FWD_EPI = "    lf_epilogue<BF16, MX>(tot, p, tl.n0, tile * LW_T + 64 * w, pos);"
BWD_EPI = ("    lb_epilogue<BF16, MX>(tot, z_s, p, db, tl.n0, tile * LW_T + 64 * w, r_w, r_a, "
           "pos.g, pos.t);")
BWD_FEED = """        iit::mbar_expect_tx(full + s, kLfW + P::W * LF_PLANE);
        iit::tensor_g2s(st, tm_g, kc * LF_KC, (int)(tile * LW_T), mg, full + s);
        iit::bulk_g2s(st + kLfW, wp + (size_t)kc * P::W * (LF_KC * LW_N), P::W * LF_PLANE,
                      full + s);"""
BWD_ZFEED = """          iit::mbar_expect_tx(zfull, LW_T * LW_N * 4);
#pragma unroll
          for (int b = 0; b < LW_N / 32; ++b)
            iit::tensor_g2s(z_s + b * kLfW, tm_z, tl.n0 + 32 * b, (int)(tile * LW_T), mz, zfull);"""
DW_GSPLIT = ("      ld_split_g<P::G>(smem + f * kLdF32, smem + kLdPl + ps * kLdSlot, valid(k), "
             "tid);")
DW_ASPLIT = "    iit::split_planes<NP>(x0, x1, pl);"
# the first and last layers' streaming passes: the feeds and the stores
F_RING = """      ls_rows(x_ring + s * (LW_T * MAX_IO), p.src, tile * LW_T * in_size, n * in_size,
              LW_T * in_size, lane);"""
F_STORE = "      if (row < n) {\n        if (z_out != nullptr)"
L_RING = """      if (lane == 0) {
        iit::mbar_expect_tx(full + s, (uint32_t)kLsZ);
#pragma unroll
        for (int b = 0; b < LW_N / 32; ++b)
          iit::tensor_g2s(st + b * kLfW, tm_z, tl.n0 + 32 * b, (int)(tile * LW_T), mz, full + s);
      }"""
L_STORE = ("      if (valid) *reinterpret_cast<float2*>(g_out + row * h) = "
           "make_float2(gb[0], gb[1]);")


def _rep(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/sine_mlp.cu no longer holds {old[:60]!r} once")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    """{(part, name): source}: part 0 the forward, 1 the backward, 2 dW
    (SINE_MLP_LAYER)."""
    no_mma = _rep(src, (PASS0, ""), (PASS1, ""))
    return {
        (0, "full"): src, (0, "no_mma"): no_mma,
        (0, "no_split"): _rep(src, (FWD_SPLIT, "    pl[0] = __float_as_uint(v.x);\n"
                                               "    if (NP > 1) pl[NP - 1] = __float_as_uint(v.y);")),
        (0, "no_epi"): _rep(src, (FWD_EPI, "    if (tot[0] == 12345.f) " + FWD_EPI.strip())),
        (0, "no_fring"): _rep(src, (F_RING, "")),
        (0, "no_fstore"): _rep(src, (F_STORE, "      if (row < n && z[0] == 12345.f) {\n"
                                               "        if (z_out != nullptr)")),
        (1, "full"): src, (1, "no_mma"): no_mma,
        (1, "no_epi"): _rep(src, (BWD_EPI, "    if (tot[0] == 12345.f) " + BWD_EPI.strip())),
        (1, "no_feed"): _rep(src, (BWD_FEED, "        iit::mbar_arrive(full + s);"),
                             (BWD_ZFEED, "          iit::mbar_arrive(zfull);")),
        (1, "no_lring"): _rep(src, (L_RING, "      if (lane == 0) iit::mbar_arrive(full + s);")),
        (1, "no_lstore"): _rep(src, (L_STORE, "      if (valid && gb[0] == 12345.f) "
                                              + L_STORE.strip()[len("if (valid) "):])),
        (2, "full"): src, (2, "no_mma"): no_mma,
        (2, "no_gsplit"): _rep(src, (DW_GSPLIT, "")),
        (2, "no_asplit"): _rep(src, (DW_ASPLIT, "    pl[0] = __float_as_uint(x0);\n"
                                                "    if (NP > 1) pl[NP - 1] = __float_as_uint(x1);")),
    }


def _build(root: Path, key, text: str):
    part, name = key
    d = root / f"part{part}_{name}"
    d.mkdir(parents=True)
    (d / "sine_mlp.cu").write_text(text)
    for h in cb.CSRC.glob("*.cuh"):
        shutil.copy(h, d / h.name)
    subprocess.run([cb._nvcc(), cb._ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    f"-DSINE_MLP_LAYER={part}", "-o", str(d / "lib.so"), str(d / "sine_mlp.cu")],
                   check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(d / "lib.so")),
                 ("sine_mlp_layer_fwd", "sine_mlp_layer_bwd", "sine_mlp_layer_dw")[part])
    fn.argtypes, fn.restype = cb._SIGNATURES[fn.__name__]
    return fn


def _ms(call, reps: int = 10) -> float:
    if call() != 0:
        raise RuntimeError("a knock-out launch failed")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[640, 1024])
    ap.add_argument("--out", default="outputs/layer_knockouts.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layer_knockouts: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    srcs = variants((cb.CSRC / "sine_mlp.cu").read_text())
    root = Path(tempfile.mkdtemp(prefix="layer_knockouts_"))
    with ThreadPoolExecutor(len(srcs)) as ex:
        fns = dict(zip(srcs, ex.map(lambda kv: _build(root, *kv), srcs.items())))
    dev = torch.device("cuda")
    n = 512 * 512
    stream = torch.cuda.current_stream(dev).cuda_stream
    record = {"card": card, "rows": n, "ms": {}}
    for h in args.widths:
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.sin(torch.randn((n, h), device=dev, generator=gen))
        g = torch.randn((n, h), device=dev, generator=gen) / n
        w = torch.randn((h, h), device=dev, generator=gen) / h ** 0.5
        b = torch.zeros(h, device=dev)
        out = torch.empty_like(a)
        z = torch.randn((n, h), device=dev, generator=gen)  # A written over it each launch
        slices = sm.layer_slices(n, h, torch.cuda.get_device_properties(dev).multi_processor_count)
        part = torch.empty((slices, h * h), device=dev)
        # the first and last layers' operands (in = 2, out = 3)
        x = torch.rand((n, 2), device=dev, generator=gen) * 2 - 1
        w0 = torch.randn((2, h), device=dev, generator=gen)
        wl = torch.randn((h, 3), device=dev, generator=gen) / h ** 0.5
        g3 = torch.randn((n, 3), device=dev, generator=gen) / n
        zs, o3, dx = torch.empty_like(a), torch.empty((n, 3), device=dev), torch.empty((n, 2), device=dev)
        common = dict(n=n, hidden=h, slices=slices, members=1)
        for prec in ("fp32", "bf16"):
            bf16, mixed = sm.precision_modes(prec)
            flags = sm._mode_flags(bf16, mixed)
            planes = sm._layer_planes(w[None], bf16, mixed)[0]
            fwd = sm._layer_args(n=n, in_size=1, hidden=h, out_size=1, slices=slices, members=1,
                                 omega=30.0, src=a[None], w=planes[None], b=b[None],
                                 dst=out[None])
            tplanes = sm._layer_planes(w.t()[None], bf16, mixed)[0]
            bwd = sm._layer_args(n=n, in_size=1, hidden=h, out_size=1, slices=slices, members=1,
                                 omega=30.0, n_part=h * h, offsets=dict(off_db=0), g=g[None],
                                 w=tplanes[None], z=z[None], dst=out[None], part=part[None])
            dw = sm._layer_args(n=n, in_size=1, hidden=h, out_size=1, slices=slices, members=1,
                                n_part=h * h, offsets=dict(off_dw=0), src=a[None], g=g[None],
                                part=part[None])
            first = sm._layer_args(in_size=2, out_size=1, omega=30.0, src=x[None], w=w0[None],
                                   b=b[None], dst=out[None], z=zs[None], **common)
            last = sm._layer_args(in_size=1, out_size=3, src=out[None], w=wl[None], b=b[None],
                                  dst=o3[None], **common)
            blast = sm._layer_args(in_size=1, out_size=3, omega=30.0, n_part=h * h,
                                   offsets=dict(off_db=0, off_dwl=h, off_dbl=4 * h),
                                   src=g3[None], w=wl[None], z=z[None], dst=out[None],
                                   part=part[None], **common)
            bfirst = sm._layer_args(in_size=2, out_size=1, g=g[None], w=w0[None], dst=dx[None],
                                    **common)
            # (part, kind): the kernel timed, its arguments
            kinds = {(0, 1): ("sine_mlp_layer_fwd (one hidden layer)", fwd),
                     (0, 0): ("sine_mlp_layer_fwd (the first layer, with the stash)", first),
                     (0, 2): ("sine_mlp_layer_fwd (the last layer)", last),
                     (1, 1): ("sine_mlp_layer_bwd (one hidden layer)", bwd),
                     (1, 2): ("sine_mlp_layer_bwd (the last layer)", blast),
                     (1, 0): ("sine_mlp_layer_bwd (the first layer)", bfirst),
                     (2, None): ("sine_mlp_layer_dw", dw)}
            calls = {(key, kind): (lambda fn=fn, k=kind, la=la: fn(ctypes.byref(la), k, flags, stream))
                     if kind is not None else (lambda fn=fn, la=la: fn(ctypes.byref(la), flags, stream))
                     for key, fn in fns.items()
                     for (part_no, kind), (_, la) in kinds.items() if part_no == key[0]}
            times = {}
            for _ in range(2):  # the second round is kept
                times = {key: _ms(call) for key, call in calls.items()}
            for (part_no, kind), (kernel, _) in kinds.items():
                row = {name: t for ((p, name), k), t in times.items()
                       if p == part_no and k == kind}
                record["ms"][f"{kernel} w{h} {prec}"] = row
                print(f"[layer_knockouts] {kernel} w{h} {prec}: "
                      + ", ".join(f"{name} {t:.4f}" for name, t in row.items()) + " ms",
                      flush=True)
    print(f"[layer_knockouts] {card}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    shutil.rmtree(root, ignore_errors=True)
    return record


if __name__ == "__main__":
    main()
