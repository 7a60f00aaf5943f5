"""Where the time of the SIREN kernels goes, on the card.

    python -m implicit_image_tpu_torch.tools.kernel_breakdown [--out FILE]

Builds copies of csrc/sine_mlp.cu with one part knocked out each (their
results are wrong by design), all at once (each in the parts of
ops/cuda_build.build), and
times sine_mlp_fwd and sine_mlp_bwd of each in the fp32 mode at the main
path's shapes (512^2 pixels, d8, w128; CUDA events over 10 launches after
a warm-up). The differences to "full" say what each part costs:

  no_sine     the sine polynomial of the forward epilogues (z passes through)
  no_mma      the hidden layers' products (fragment loads, splits, mma)
  no_stash    the backward's z stash (stores, and the copies back)
  no_partial  the backward's read-modify-write of the dW partials
  no_both     no_stash and no_partial together

It then builds and runs tools/mma_rate.cu, the rate of mma.sync alone.
Prints one line per variant and writes the record, with the card's name
and power limit, as JSON to --out.
"""
from __future__ import annotations

import argparse
import ctypes
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


def _rep(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"csrc/sine_mlp.cu no longer holds {old[:60]!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    stash_st = ("        if (KEEP == kStashZ) *reinterpret_cast<float2*>(&z_g[sw<S>(r, c)]) = "
                "make_float2(z0, z1);")
    copy_z = "    asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\\n\"\n" \
             "                 ::\"r\"(smem_addr(dst + 4 * e)), \"l\"(src + 4 * e) : \"memory\");"
    part_ld, part_st = ("      move_partial<true>(acc, dw, w);",
                        "      move_partial<false>(acc, dw, w);")
    no_stash = _rep(_rep(src, stash_st, ""), copy_z, "    ;")
    return {
        "full": src,
        "no_sine": _rep(_rep(src, "iit::fast_sin(omega * z0)", "z0"),
                        "iit::fast_sin(omega * z1)", "z1"),
        "no_mma": _rep(src, "  const PA pa(A, w.m0, w);", "  return;\n  const PA pa(A, w.m0, w);"),
        "no_stash": no_stash,
        "no_partial": _rep(_rep(src, part_ld, "      zero(acc);"), part_st,
                           "      if (acc[0][0][0] == 12345.f) " + part_st.strip()),
        "no_both": _rep(_rep(no_stash, part_ld, "      zero(acc);"), part_st,
                        "      if (acc[0][0][0] == 12345.f) " + part_st.strip()),
    }


def _build(src: Path, out: Path) -> None:
    if src.suffix == ".cu":  # tools/mma_rate.cu: a program
        cmd = [cb._nvcc(), cb._ARCH, "-std=c++17", "-O3", "-o", str(out), str(src)]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    else:  # a copy of csrc/: the library, built in its parts
        cb.build(src, out)


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="outputs/kernel_breakdown.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_breakdown: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    srcs = variants((cb.CSRC / "sine_mlp.cu").read_text())
    tmp = Path(tempfile.mkdtemp(prefix="kernel_breakdown_"))
    for name, text in srcs.items():
        (tmp / name).mkdir()
        (tmp / name / "sine_mlp.cu").write_text(text)
        (tmp / name / "fast_math.cuh").write_text((cb.CSRC / "fast_math.cuh").read_text())
    jobs = [(tmp / n, tmp / n / "lib.so") for n in srcs]
    jobs.append((TOOLS / "mma_rate.cu", tmp / "mma_rate"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda j: _build(*j), jobs))

    dev = torch.device("cuda")
    mdef, mcfg = build_model("siren", depth=8, hidden_size=128)
    gen = torch.Generator().manual_seed(0)
    params = mdef.init(gen, mcfg, dev)
    x = (get_grid(512, 512, dev).reshape(-1, 2) - 0.5) * 2.0
    g = (torch.randn((x.shape[0], 3), generator=gen) / x.shape[0]).to(dev)
    record = {"card": card, "variants": {}}
    saved = cb._state["lib"]
    try:
        for name in srcs:
            cb._state["lib"] = _load(tmp / name / "lib.so")
            fwd = _time_ms(lambda: sm.sine_mlp_fwd(params, x, mcfg, "fp32"))
            bwd = _time_ms(lambda: sm.sine_mlp_bwd(params, x, g, mcfg, "fp32"))
            record["variants"][name] = {"fwd_ms": fwd, "bwd_ms": bwd}
            print(f"[breakdown] {name:10s} fwd {fwd:.4f} ms, bwd {bwd:.4f} ms", flush=True)
    finally:
        cb._state["lib"] = saved
    rate = subprocess.run([str(tmp / "mma_rate")], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    record["mma_rate"] = rate.strip().splitlines()
    for line in record["mma_rate"]:
        print(f"[mma rate] {line}", flush=True)
    print(f"[breakdown] {card}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
