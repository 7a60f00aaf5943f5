"""Where the time of the SIREN kernels goes, on the card.

    python -m implicit_image_tpu_torch.tools.kernel_breakdown [--out FILE]
        [--widths 128 182 512] [--variants full ...] [--precisions fp32 ...]
        [--members M] [--build-dir DIR] [--build-only]

Builds copies of csrc/sine_mlp.cu with one part knocked out each (their
results are wrong by design), a few at a time (each in the parts of
ops/cuda_build.build), and times sine_mlp_fwd and sine_mlp_bwd of each
(through their wrappers) in the fp32 mode at the main path's shapes (512^2
pixels, d8) at every width of --widths (CUDA events over 10 launches after
a warm-up), and above 192 sine_mlp_layer_dw alone on one hidden layer's
operands (its row splits those of the backward). The knock-outs reach the
fused kernels of widths 128 and 192 (the layer-wise kernels' own are
tools/layer_knockouts.py's); the differences to "full" say what each part
costs:

  no_sine       the sine polynomial of the forward epilogues (z passes through)
  no_mma        the hidden layers' products: at width 128 the issue of every
                wgmma of the forward and the backward, and the dW product's
                operand loads; in the width-192 backward every wgmma (the
                ring's products and the dW pieces); in the width-192 forward
                every wgmma (the ring still streams W)
  no_stash      the backward's z stash (stores, and the copies or loads back)
  no_partial    the backward's dW traffic: the bulk reduce-adds of the staged
                dW into the partials
  no_both       no_stash and no_partial together
  no_ring_wait  in the width-192 forward the products' wait for their slice
                (its fills complete the slot's barrier at once, the copies
                land on barriers of their own, which the next fill and the
                block's end wait for); the other kernels keep theirs, so
                there it times "full"
  no_ring_copy  the wgmma kernels' ring fills copy nothing (each fill's
                mbarrier completes at once; the products read what the slot
                holds): the time of streaming W's planes from L2

Above 192 each variant also times K1 and K2 under autograd, as a fit step
runs them (siren_apply_flat_fused on leaves that require grad, then the
backward: K2 takes the z stash that K1 filled, where the tree has one).
--variants picks some of them (default: all), --precisions the modes timed
(default fp32; the forward and the backward in each), --members M also
times sine_mlp_fwd_batched and sine_mlp_bwd_batched over M members in each
mode, --split also runs one fp32 K2 under torch.profiler and records
each kernel's device ms and launches (the layer-wise forward's and
backward's by kind: first, hidden, last; above 192 the K2 under autograd
and the K1 under autograd that fills its stash too). --build-dir keeps
the built files there, each under the hash of the sources it was built from,
and reuses one only for the same sources (--build-only builds and stops), so
that two trees can share the directory and be timed in turns without
building again; "full", the checkout's own source, is its library
(ops/cuda_build.load_library, built under build/ of the checkout), which the
checkout's other tools then load as built. The variants match the source of
this commit; an older checkout is measured with its own copy of this tool.
It then builds and runs
tools/mma_rate.cu: the rates of mma.sync and wgmma alone, and its checks of
csrc/hopper.cuh's building blocks (their exit code is recorded). Prints one
line per variant and width, and writes the record, with the card's name and
power limit, as JSON to --out. For "full" it also records the sha256 of the
fp32 forward's output and of the backward's results (above 192 also of the
autograd pair's), so that two trees' runs show whether their bits agree.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops import cuda_build as cb
from implicit_image_tpu_torch.ops import sine_mlp as sm

TOOLS = Path(__file__).resolve().parent
BUILDS_AT_ONCE = 3  # variant libraries built together (each runs its parts at once)


def _rep(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"csrc/sine_mlp.cu no longer holds {old[:60]!r}")
    return src.replace(old, new)


def _never(line: str) -> str:
    """The statement `line` behind a condition that never holds."""
    indent = line[: len(line) - len(line.lstrip())]
    return f"{indent}if (acc[0][0][0] == 12345.f) {line.strip()}"


# the width-128 backward on wgmma (this commit): its dW reduce-adds, its z
# stash's stores and copies back, its products (issue and operand feed)
WG_REDUCE = "  iit::bulk_reduce_add(dw, gz_s, H * H * 4);"
WG_STASH = ("      if (STASH) __stcg(reinterpret_cast<float2*>(&z_g[as_idx(r, c)]), "
            "make_float2(z0, z1));")
WG_COPY = "  iit::mbar_expect_tx(bar, T * H * 4);\n  iit::bulk_g2s(a_s, z, T * H * 4, bar);"
WG_PASSES = "                                          uint32_t b0, uint32_t bstride, bool first) {\n"
WG_DW = "  const float* ah = a_s + p.wg * (T * 64);"
# the width-192 backward on wgmma (this commit): its products, z stash and
# dW reduce-adds
B2_SS = "          iit::wg_bf16_ss_n96<0, TB>("
B2_RS = "          iit::wg_bf16_n96<1>(acc, ak[i],"
B2_STASH = "      if (STASH) __stcg(b2_stash(z_g, ni, h, tid), make_float2(z0, z1));"
B2_LOAD = "        z = __ldcg(b2_stash(const_cast<float*>(z_g), ni, h, tid));"
B2_REDUCE = ("          iit::bulk_reduce_add(dw + mp * 2 * B2_PIECE, stage, B2_PIECE * 4,\n"
             "                               iit::l2_evict_first());")
# the wgmma kernels' ring of W's planes (this commit): a fill's bulk copy
RING_COPY = """    iit::mbar_expect_tx(bar(b), bytes);
    iit::bulk_g2s(slot(b),
                  planes + ((size_t)((fwd ? 0 : L) + layer) * R::NS + j % R::NS) * NP * R::PLANE,
                  bytes, bar(b));"""
# the width-192 forward on wgmma (this commit): its products and the end of
# its tile loop
F2_SS = "            iit::wg_bf16_ss_n96<0, 1>("
F2_END = "    f2_out<BF16>(d, c, OUT(), rows0, B2Pos(tid_l & 127));\n  }\n"
# no_ring_wait there (the ring of the width-192 forward only: HW 192, one
# image): a fill completes the slot's mbarrier when it is issued, so the
# products wait for no copy while the ring still paces the warps, and the
# copy lands on a barrier of its own (`landed`), which the slot's next fill
# and the block's end wait for
RING_BAR = """  __device__ __forceinline__ uint64_t* bar(int b) const {
    return reinterpret_cast<uint64_t*>(smem + R::BAR) + b;
  }
"""
RING_LAND = """  __device__ __forceinline__ uint64_t* land(int b) const {
    __shared__ uint64_t landed[32];
    return landed + b;
  }
"""
RING_INIT = "      iit::mbar_init(bar(b), 1);\n"
F2_RING = "R::HW == 192 && R::IMAGES == 1"
F2_COPY = f"""    if constexpr ({F2_RING}) {{
      if (q >= R::NB) iit::mbar_wait(land(b), (q / R::NB - 1) & 1);
      iit::mbar_arrive(bar(b));
      iit::mbar_expect_tx(land(b), bytes);
      iit::bulk_g2s(slot(b),
                    planes + ((size_t)((fwd ? 0 : L) + layer) * R::NS + j % R::NS) * NP * R::PLANE,
                    bytes, land(b));
      return;
    }}
"""
F2_DRAIN = """  __syncthreads();
  if (tid0 == 0)
    for (int b = 0; b < R::NB && b < ring.total; ++b)
      iit::mbar_wait(ring.land(b), ((ring.total - 1 - b) / R::NB) & 1);
"""


def _no_partial(src: str) -> str:
    """The wgmma backwards' bulk reduce-adds of dW into the partials knocked
    out."""
    return _rep(_rep(src, B2_REDUCE, ""), WG_REDUCE, "")


def variants(src: str) -> dict:
    no_stash = _rep(_rep(src, WG_STASH, ""), WG_COPY, "  iit::mbar_arrive(bar);")
    no_stash = _rep(_rep(no_stash, B2_STASH, ""), B2_LOAD, "        z = make_float2(0.f, 0.f);")
    no_mma = _rep(_rep(src, WG_PASSES, WG_PASSES + "  return;\n"), WG_DW, "  return;\n" + WG_DW)
    no_mma = _rep(_rep(no_mma, B2_SS, "          if (u == 12345) " + B2_SS.lstrip()),
                  B2_RS, "          if (kk == 12345) " + B2_RS.lstrip())
    no_mma = _rep(no_mma, F2_SS, "            if (u == 12345) " + F2_SS.lstrip())
    # the width-192 forward's products wait for no copy
    no_ring_wait = _rep(src, F2_END, F2_END + F2_DRAIN)
    no_ring_wait = _rep(_rep(no_ring_wait, RING_BAR, RING_BAR + RING_LAND), RING_INIT,
                        RING_INIT + f"      if constexpr ({F2_RING}) iit::mbar_init(land(b), 1);\n")
    no_ring_wait = _rep(no_ring_wait, RING_COPY, F2_COPY + RING_COPY)
    return {
        "full": src,
        "no_sine": _rep(_rep(src, "iit::fast_sin(omega * z0)", "z0"),
                        "iit::fast_sin(omega * z1)", "z1"),
        "no_mma": no_mma,
        "no_stash": no_stash,
        "no_partial": _no_partial(src),
        "no_both": _no_partial(no_stash),
        "no_ring_wait": no_ring_wait,
        # the fills arrive at once, copying nothing: W's streaming cost
        "no_ring_copy": _rep(src, RING_COPY, "    iit::mbar_arrive(bar(b));"),
    }


def _build(src: Path, out: Path) -> None:
    if src.suffix == ".cu":  # tools/mma_rate.cu: a program
        cmd = [cb._nvcc(), cb._ARCH, "-std=c++17", "-O3", "-o", str(out), str(src)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{done.stderr[-4000:]}")
    else:  # a copy of csrc/: the library, built in its parts
        cb.build(src, out)


def _digest(*texts: str) -> str:
    """What a built file is keyed by in --build-dir: the sources it was
    built from, so a library is reused only for the same sources."""
    h = hashlib.sha256(cb._ARCH.encode())
    for text in texts:
        h.update(text.encode())
    return h.hexdigest()[:16]


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in cb._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


def _time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_kind(name: str):
    """The kind (0 first, 1 hidden, 2 last: the third template argument) of a
    layer-wise forward or backward kernel's name, as ptxas's demangler
    ("(int)1") or the profiler ("1") writes it; None for other kernels."""
    for kernel in ("sine_mlp_layer_fwd_kernel<", "sine_mlp_layer_bwd_kernel<"):
        if kernel in name:
            return int(name.split(kernel)[1].split(">")[0].split(",")[2].strip()[-1])
    return None


def kernel_split(fn, prepare=None) -> dict:
    """One call of fn under torch.profiler, after one unprofiled: {kernel:
    [device ms, launches]}, the layer-wise kernels by name
    (sine_mlp_layer_fwd_kernel and sine_mlp_layer_bwd_kernel by kind:
    first, hidden, last), the others by the start of theirs. With
    `prepare`, each call is fn(prepare()), prepare run outside the profile
    (a forward under autograd whose z stash the backward fn takes)."""
    from torch.profiler import ProfilerActivity, profile

    from implicit_image_tpu_torch import profile_fit

    def call():
        arg = () if prepare is None else (prepare(),)
        torch.cuda.synchronize()
        return lambda: fn(*arg)

    call()()
    torch.cuda.synchronize()
    run = call()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "k2.trace.json"
        prof.export_chrome_trace(str(trace))
        rows = profile_fit.trace_breakdown(trace, 1)["rows"]
    kinds = {0: "first", 1: "hidden", 2: "last"}
    split = {}
    for row in rows:
        name = row["name"]
        key = next((k for k in ("sine_mlp_layer_fwd_kernel", "sine_mlp_layer_bwd_kernel",
                                "sine_mlp_layer_dw_kernel", "sum_partials_kernel")
                    if k in name), name[:60])
        if key in ("sine_mlp_layer_fwd_kernel", "sine_mlp_layer_bwd_kernel"):
            key += " " + kinds[layer_kind(name)]
        got = split.setdefault(key, [0.0, 0])
        got[0] += row["ms"]
        got[1] += row["count"]
    return split


def autograd_forward(params, coords, cfg, precision: str = "fp32"):
    """K1 as a fit step runs it: siren_apply_flat_fused on copies of the
    leaves that require grad (above 192 it fills the z stash where the
    tree's Function does) -> out, whose backward is K2 (from the stash, or
    with its recompute), and the leaves."""
    leaves = [{k: layer[k].detach().clone().requires_grad_(True) for k in ("w", "b")}
              for layer in params]
    return sm.siren_apply_flat_fused(leaves, coords, cfg, precision), leaves


def autograd_ms(params, coords, g, cfg, precision: str = "fp32", reps: int = 5):
    """(K1 ms, K2 ms) under autograd (`autograd_forward`, then
    out.backward(g)): medians of `reps` calls after one, each between CUDA
    events. g passes the output map (/ 2) on its way, a few microseconds."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fwd, bwd = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        start.record()
        out, _ = autograd_forward(params, coords, cfg, precision)
        end.record()
        torch.cuda.synchronize()
        fwd.append(start.elapsed_time(end))
        start.record()
        out.backward(g)
        end.record()
        torch.cuda.synchronize()
        bwd.append(start.elapsed_time(end))
        del out
    return sorted(fwd[1:])[reps // 2], sorted(bwd[1:])[reps // 2]


def _sha256(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="outputs/kernel_breakdown.json")
    ap.add_argument("--widths", type=int, nargs="+", default=[128, 182, 512])
    ap.add_argument("--variants", nargs="+", default=None)
    ap.add_argument("--precisions", nargs="+", default=["fp32"])
    ap.add_argument("--members", type=int, default=0)
    ap.add_argument("--build-dir", default=None)
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_breakdown: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    own = (cb.CSRC / "sine_mlp.cu").read_text()
    srcs = variants(own)
    if args.variants:
        srcs = {n: srcs[n] for n in args.variants}
    tmp = Path(args.build_dir or tempfile.mkdtemp(prefix="kernel_breakdown_"))
    tmp.mkdir(parents=True, exist_ok=True)
    headers = {h.name: h.read_text() for h in sorted(cb.CSRC.glob("*.cuh"))}
    parts, libs, jobs = repr(sorted(cb._PARTS.items())), {}, []
    for name, text in srcs.items():
        if text == own:  # the checkout's own library, where its other callers find it
            libs[name] = None
            continue
        part = tmp / f"{name}_{_digest(text, *headers.values(), parts)}"
        libs[name] = part / "lib.so"
        if libs[name].is_file():
            continue
        part.mkdir(parents=True, exist_ok=True)
        (part / "sine_mlp.cu").write_text(text)
        for header, header_text in headers.items():
            (part / header).write_text(header_text)
        jobs.append((part, libs[name]))
    rate_src = TOOLS / "mma_rate.cu"
    rate_bin = tmp / f"mma_rate_{_digest(rate_src.read_text(), *headers.values())}"
    if not rate_bin.is_file():
        jobs.append((rate_src, rate_bin))
    with ThreadPoolExecutor(BUILDS_AT_ONCE) as ex:
        list(ex.map(lambda j: _build(*j), jobs))
    own_lib = cb.load_library() if None in libs.values() else None
    if args.build_only:
        return {}

    dev = torch.device("cuda")
    coords = get_grid(512, 512, dev).reshape(-1, 2)
    x = (coords - 0.5) * 2.0
    record = {"card": card, "widths": {}}
    saved = cb._state["lib"]
    try:
        for width in args.widths:
            mdef, mcfg = build_model("siren", depth=8, hidden_size=width)
            gen = torch.Generator().manual_seed(0)
            params = mdef.init(gen, mcfg, dev)
            g = (torch.randn((x.shape[0], 3), generator=gen) / x.shape[0]).to(dev)
            rows = record["widths"][width] = {}
            hidden = sm.kernel_width(width)
            # sine_mlp_layer_dw alone above 192: one hidden layer, the backward's splits
            layer_dw_args = None
            if hidden > sm.KERNEL_WIDTHS[-1]:
                slices, n_part, sizes = sm.partial_layout(x.shape[0], 8, 2, width, 3, dev)
                ops = torch.randn((2, x.shape[0], hidden), device=dev)
                layer_dw_args = (*ops, torch.empty((slices, n_part), device=dev), sizes[0],
                                 "fp32")
            members = [mdef.init(gen, mcfg, dev) for _ in range(args.members)]
            gm = (torch.randn((args.members, x.shape[0], 3), generator=gen)
                  / x.shape[0]).to(dev)
            for name in srcs:
                cb._state["lib"] = own_lib if libs[name] is None else _load(libs[name])
                fwd = _time_ms(lambda: sm.sine_mlp_fwd(params, x, mcfg, "fp32"))
                bwd = _time_ms(lambda: sm.sine_mlp_bwd(params, x, g, mcfg, "fp32"))
                rows[name] = {"fwd_ms": fwd, "bwd_ms": bwd}
                line = f"[breakdown w{width}] {name:12s} fwd {fwd:.4f} ms, bwd {bwd:.4f} ms"
                for prec in args.precisions:
                    if prec != "fp32":
                        rows[name][f"fwd_ms_{prec}"] = _time_ms(
                            lambda: sm.sine_mlp_fwd(params, x, mcfg, prec))
                        rows[name][f"bwd_ms_{prec}"] = _time_ms(
                            lambda: sm.sine_mlp_bwd(params, x, g, mcfg, prec))
                        line += (f", fwd {prec} {rows[name][f'fwd_ms_{prec}']:.4f} ms, bwd {prec} "
                                 f"{rows[name][f'bwd_ms_{prec}']:.4f} ms")
                    if args.members:
                        m_key = f"{prec}_x{args.members}"
                        rows[name][f"fwd_ms_{m_key}"] = _time_ms(
                            lambda: sm.sine_mlp_fwd_batched(members, x, mcfg, prec), 5)
                        rows[name][f"bwd_ms_{m_key}"] = _time_ms(
                            lambda: sm.sine_mlp_bwd_batched(members, x, gm, mcfg, prec), 5)
                        line += (f", over {args.members} members fwd {prec} "
                                 f"{rows[name][f'fwd_ms_{m_key}']:.4f} ms, bwd {prec} "
                                 f"{rows[name][f'bwd_ms_{m_key}']:.4f} ms")
                if name == "full":
                    dx, grads = sm.sine_mlp_bwd(params, x, g, mcfg, "fp32")
                    rows[name]["fwd_sha256"] = _sha256(sm.sine_mlp_fwd(params, x, mcfg, "fp32"))
                    rows[name]["bwd_sha256"] = _sha256(dx, *(t for gr in grads
                                                              for t in gr.values()))
                    line += (f", sha256 fwd {rows[name]['fwd_sha256']} bwd "
                             f"{rows[name]['bwd_sha256']}")
                if hidden > sm.KERNEL_WIDTHS[-1]:  # K1 and K2 as a fit step runs them
                    k1_ms, k2_ms = autograd_ms(params, coords, g, mcfg)
                    rows[name]["fwd_autograd_ms"], rows[name]["bwd_autograd_ms"] = k1_ms, k2_ms
                    line += f", under autograd fwd {k1_ms:.4f} ms, bwd {k2_ms:.4f} ms"
                    if name == "full":
                        out, leaves = autograd_forward(params, coords, mcfg)
                        out.backward(g)
                        rows[name]["autograd_sha256"] = _sha256(
                            out, *(layer[k].grad for layer in leaves for k in ("w", "b")))
                        line += f", sha256 autograd {rows[name]['autograd_sha256']}"
                        del out, leaves
                if args.split:
                    rows[name]["k2_split"] = kernel_split(
                        lambda: sm.sine_mlp_bwd(params, x, g, mcfg, "fp32"))
                    line += ", K2's kernels (device ms / launches): " + "; ".join(
                        f"{k} {ms:.3f} / {n}" for k, (ms, n) in rows[name]["k2_split"].items())
                    if hidden > sm.KERNEL_WIDTHS[-1]:
                        rows[name]["k2_split_autograd"] = kernel_split(
                            lambda out: out.backward(g),
                            lambda: autograd_forward(params, coords, mcfg)[0])
                        line += "; under autograd: " + "; ".join(
                            f"{k} {ms:.3f} / {n}"
                            for k, (ms, n) in rows[name]["k2_split_autograd"].items())
                        rows[name]["k1_split_autograd"] = kernel_split(
                            lambda: autograd_forward(params, coords, mcfg))
                        line += "; K1 under autograd: " + "; ".join(
                            f"{k} {ms:.3f} / {n}"
                            for k, (ms, n) in rows[name]["k1_split_autograd"].items())
                if layer_dw_args is not None:
                    rows[name]["layer_dw_ms"] = _time_ms(
                        lambda: sm.sine_mlp_layer_dw(*layer_dw_args))
                    line += f", sine_mlp_layer_dw alone {rows[name]['layer_dw_ms']:.4f} ms"
                print(line, flush=True)
    finally:
        cb._state["lib"] = saved
    rate = subprocess.run([str(rate_bin)], capture_output=True, text=True,
                          timeout=120)
    record["mma_rate"] = rate.stdout.strip().splitlines()
    record["mma_rate_exit"] = rate.returncode
    for line in record["mma_rate"]:
        print(f"[mma rate] {line}", flush=True)
    print(f"[breakdown] {card}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
