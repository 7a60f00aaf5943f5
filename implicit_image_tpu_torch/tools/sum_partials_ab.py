"""Candidates for sum_partials, K2's cross-block gradient sum, timed in turns
with partials.sum(0) on the card.

    python -m implicit_image_tpu_torch.tools.sum_partials_ab [--out FILE]

Builds, all at once (each in the parts of ops/cuda_build.build), copies of
csrc/sine_mlp.cu with the partial-sum constants changed (COPIES: row
groups, lanes per group, blocks per SM, loads in flight; the shipped design
is the first) and tools/sum_partials_variants.cu (the replaced scalar kernel, a cluster
design, and a flat read of the same bytes: what reading them costs). On
the main path's partial buffer (132 x 99,844 fp32 at 512^2, d8, w128;
random, from a seed), each sum must equal sum_partials_reference with its
own group count bit for bit, give the same bits twice, and stay within
1e-6 (relative) of partials.sum(0). Then every candidate, the wrapper
(sm.sum_partials) and partials.sum(0) are timed in turns, `--rounds`
rounds of `--reps` launches each (CUDA events), three ways:

  eager       launched from Python (host time included)
  graph       replayed from a CUDA graph (the device's time alone)
  graph_cold  the same, alternating two buffers (no input found in L2)

It prints every round and the medians beside the bound (each slice read
once, the sum written once, at 3.35 TB/s), the host microseconds of the
wrapper and of its parts, and writes the record, with the card's name and
power limit, as JSON to --out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from implicit_image_tpu_torch.ops import cuda_build as cb
from implicit_image_tpu_torch.ops import sine_mlp as sm

TOOLS = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BLOCKS, N_PART = 132, 99_844  # partial_layout at 512^2, d8, w128 on 132 SMs
TOL = 1e-6

# copies of csrc/sine_mlp.cu: name -> (row groups, lanes per group, blocks
# per SM, loads in flight per thread); the first is the shipped design
COPIES = {
    "g2_l192_k1_u16": (2, 192, 1, 16),
    "g2_l192_k1_u8": (2, 192, 1, 8),
    "g2_l96_k2_u16": (2, 96, 2, 16),
    "g3_l192_k1_u16": (3, 192, 1, 16),
    "g4_l192_k1_u12": (4, 192, 1, 12),
    "g8_l32_k4_u8": (8, 32, 4, 8),
    "g16_l32_k2_u8": (16, 32, 2, 8),
    "g1_l192_k1_u16": (1, 192, 1, 16),
}
_CONSTANTS = ("kSumGroups", "kSumLanes", "kSumBlocksPerSm", "kSumUnroll")
# entry points of tools/sum_partials_variants.cu: name -> group count (None:
# not a sum, the read alone)
OTHERS = {"sum_scalar": 1, "sum_cluster2": 2, "read_flat": None}


def _copy(src: str, values) -> str:
    for name, value in zip(_CONSTANTS, values):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"csrc/sine_mlp.cu no longer defines {name} once")
    return src


def _nvcc(src: Path, out: Path) -> None:
    if src.name == "sine_mlp.cu":  # a copy of csrc/: the library, built in its parts
        cb.build(src.parent, out)
        return
    cmd = [cb._nvcc(), cb._ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")


def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    fn.argtypes = cb._SIGNATURES["sum_partials"][0]
    fn.restype = ctypes.c_int
    return fn


def _launcher(fn, partials: torch.Tensor):
    n_blocks, n_part = partials.shape

    def run() -> torch.Tensor:
        out = torch.empty((n_part,), dtype=torch.float32, device=partials.device)
        err = fn(partials.data_ptr(), out.data_ptr(), n_blocks, n_part,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with cudaError_t {err}")
        return out

    return run


def _events_ms(fn, reps: int) -> float:
    """ms per call of fn() (which launches `reps` times) between two events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _eager(fn, reps: int):
    """`reps` launches from Python: what a loop of calls costs, host included."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return run


def _graph(fns, reps: int):
    """`reps` launches captured in one CUDA graph, cycling through `fns`:
    the device's time alone, no host time between launches."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    return graph.replay


def _enqueue_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of fn, not waiting for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def build(tmp: Path) -> dict:
    """name -> (launch function factory, group count), every library built
    in parallel."""
    src = (cb.CSRC / "sine_mlp.cu").read_text()
    jobs = []
    for name, values in COPIES.items():
        (tmp / name).mkdir()
        (tmp / name / "sine_mlp.cu").write_text(_copy(src, values))
        (tmp / name / "fast_math.cuh").write_text((cb.CSRC / "fast_math.cuh").read_text())
        jobs.append((tmp / name / "sine_mlp.cu", tmp / name / "lib.so"))
    jobs.append((TOOLS / "sum_partials_variants.cu", tmp / "variants.so"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda j: _nvcc(*j), jobs))
    out = {}
    for name, (groups, *_) in COPIES.items():
        lib = ctypes.CDLL(str(tmp / name / "lib.so"))
        lib.sum_partials_groups.restype = ctypes.c_int
        if lib.sum_partials_groups() != groups:
            raise RuntimeError(f"{name}: the library's group count is not {groups}")
        out[name] = (_bind(lib, "sum_partials"), groups)
    variants = ctypes.CDLL(str(tmp / "variants.so"))
    for name, groups in OTHERS.items():
        out[name] = (_bind(variants, name), groups)
    return out


def host_costs(partials: torch.Tensor) -> dict:
    """Host microseconds per call of the wrapper and of its parts."""
    dev = partials.device
    lib = sm._lib()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)

    def in_context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "sm.sum_partials (the wrapper)": lambda: sm.sum_partials(partials),
        "partials.sum(0)": lambda: partials.sum(0),
        "torch.empty of the output": lambda: torch.empty(
            (partials.shape[1],), dtype=torch.float32, device=dev),
        "partials.new_empty of the output": lambda: partials.new_empty((partials.shape[1],)),
        "the checks (_check_cuda)": lambda: sm._check_cuda("partials", partials, dev),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(
            dev.index),
        "with torch.cuda.device(dev)": in_context,
        "the ctypes call, nothing launched": lambda: lib.sum_partials(0, 0, 0, 0, stream),
    }
    return {what: _enqueue_us(fn, 2000) for what, fn in parts.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="outputs/sum_partials_ab.json")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sum_partials_ab: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    candidates = build(Path(tempfile.mkdtemp(prefix="sum_partials_ab_")))

    dev = torch.device("cuda")
    bufs = [torch.randn((BLOCKS, N_PART), generator=torch.Generator().manual_seed(s)).to(dev)
            for s in (0, 1)]
    partials = bufs[0]
    library = partials.sum(0)
    bound_ms = 4 * (BLOCKS + 1) * N_PART / HBM_BYTES_PER_S * 1e3
    record = {"card": card, "shape": [BLOCKS, N_PART], "bound_ms": bound_ms, "candidates": {}}
    # name -> one launch on each buffer
    runs = {}
    candidates["wrapper"] = (None, sm.SUM_PARTIALS_GROUPS)
    for name, (fn, groups) in candidates.items():
        pair = ([_launcher(fn, b) for b in bufs] if fn is not None
                else [lambda b=b: sm.sum_partials(b) for b in bufs])
        runs[name] = pair
        if groups is None:  # the read alone: nothing to check
            continue
        first, second = pair[0](), pair[0]()
        torch.cuda.synchronize()
        mirror = sm.sum_partials_reference(partials, groups)
        rel = float((first - library).abs().max() / library.abs().max())
        rec = {"groups": groups, "equals_mirror": bool(torch.equal(first, mirror)),
               "repeats": bool(torch.equal(first, second)), "rel_err_vs_library": rel}
        rec["ok"] = rec["equals_mirror"] and rec["repeats"] and rel <= TOL
        record["candidates"][name] = rec
        print(f"[sum_partials_ab] {name:16s} groups {groups:2d}: equals mirror "
              f"{rec['equals_mirror']}, repeats {rec['repeats']}, rel err vs sum(0) {rel:.3e}",
              flush=True)
    runs["partials.sum(0)"] = [lambda b=b: b.sum(0) for b in bufs]

    # eager: a Python loop of launches on one buffer (host time included);
    # graph: the same launches replayed from a CUDA graph (device time);
    # graph_cold: the graph alternating two buffers, so no launch finds its
    # input in L2
    modes = {
        "eager": {n: _eager(p[0], args.reps) for n, p in runs.items()},
        "graph": {n: _graph(p[:1], args.reps) for n, p in runs.items()},
        "graph_cold": {n: _graph(p, args.reps) for n, p in runs.items()},
    }
    for name, pair in runs.items():
        us = _enqueue_us(pair[0])
        record["candidates"].setdefault(name, {})["enqueue_us"] = us
    for mode, fns in modes.items():
        times = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name, fn in fns.items():
                times[name].append(_events_ms(fn, args.reps))
        for name, ts in times.items():
            med = statistics.median(ts)
            rec = record["candidates"][name]
            rec[mode] = {"rounds_ms": ts, "median_ms": med, "share_of_bound": bound_ms / med}
            print(f"[sum_partials_ab] {mode:10s} {name:16s} median {med:.4f} ms = "
                  f"{bound_ms / med:.1%} of the {bound_ms:.4f} ms bound; rounds "
                  f"{' '.join(f'{t:.4f}' for t in ts)}; enqueue {rec['enqueue_us']:.1f} us/call",
                  flush=True)
    record["host_us"] = host_costs(partials)
    for what, us in record["host_us"].items():
        print(f"[sum_partials_ab] host {us:6.2f} us per call: {what}", flush=True)
    print(f"[sum_partials_ab] {card}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    bad = [n for n, r in record["candidates"].items() if r.get("ok") is False]
    if bad:
        raise SystemExit(f"sum_partials_ab: {bad} disagree with their mirror or repeat")
    return record


if __name__ == "__main__":
    main()
