"""Many processes: the process group, fleets of independent fits and local
process groups for checks (counterpart of
implicit_image_tpu/parallel/multihost.py).

The JAX package runs one controller per host over its local devices and
joins the hosts with `jax.distributed.initialize`. The port runs one
process per device (one rank per process: the JAX package's
`devices_per_process` has no counterpart) joined in a torch.distributed
process group:

    # the same program on every rank, e.g. under
    #   torchrun --nproc_per_node=<GPUs> --nnodes=<hosts> ... prog.py
    from implicit_image_tpu_torch.parallel.multihost import init_multihost, fleet_fit
    init_multihost()        # no arguments: env:// (torchrun's variables)
    psnrs, params = fleet_fit(torch.Generator().manual_seed(0), mdef, mcfg, grid,
                              imgs, train_cfg, optim_cfg)

`fleet_fit` fits each process's contiguous share of the images, every image
with its generator drawn over the whole list, then gathers the PSNRs once:
every process returns the fleet-wide vector, identical to a one-process
run over the same list.

`launch_dryrun(n)` checks the whole path on one machine: n worker
processes (`python -m implicit_image_tpu_torch.parallel.multihost`) meet
at a file:// rendezvous in a temporary dir (no TCP port to race for), run
a global collective and a small fleet, and write a report each. The
supervisor polls them: the moment one exits non-zero the others, which
would block in the gather, are killed and RuntimeError names it; a fleet
that does not finish within `timeout` is torn down (TimeoutError). Worker
output goes to files. On the CPU the workers use gloo; on the card NCCL,
whose communicators refuse two ranks on one device, so several workers
sharing one GPU take backend="gloo" (the collectives then stage through
host memory: parallel/collectives.py).

    python -m implicit_image_tpu_torch.parallel.multihost --dryrun 2 \\
        [--device cpu] [--backend gloo]

`run_group(fn, n)` runs fn(rank, *args) in n spawned processes joined the
same way and returns each rank's result: the tests' and chip_smoke.py's
way to run a mesh on one machine.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_multihost", "fleet_fit", "launch_dryrun", "run_group"]


def init_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                   rank: Optional[int] = None, backend: Optional[str] = None,
                   device="cuda") -> None:
    """Join the process group (idempotent). With no `init_method`, env://:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK from the environment, as
    torchrun sets them. `backend` defaults to NCCL for device "cuda" and gloo
    for "cpu"; for "cuda" the process takes the card LOCAL_RANK (or its rank)
    modulo the cards present. Raises RuntimeError for "cuda" without a CUDA
    device and for NCCL where torch has none: nothing falls back to the
    CPU."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device} but no CUDA device is available")
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                   else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("backend nccl is not available in this torch build")
    kwargs = {}
    if world_size is not None:
        kwargs = dict(world_size=int(world_size), rank=int(rank))
    dist.init_process_group(backend, init_method=init_method or "env://", **kwargs)


def _shard_bounds(n_items: int, num_procs: int, pid: int):
    """Contiguous near-even split of n_items across processes."""
    base, extra = divmod(n_items, num_procs)
    start = pid * base + min(pid, extra)
    return start, start + base + (1 if pid < extra else 0)


def fleet_fit(generator: torch.Generator, mdef, mcfg, grid, imgs, train_cfg, optim_cfg,
              masking_cfg=None, device="cuda"):
    """Fit a fleet of images (B, H, W, C) across all ranks of the process
    group; returns (the fleet-wide PSNR vector, identical on every rank,
    and this rank's params). Rank p fits its contiguous share
    (_shard_bounds) one image after the other on `device`, image i with
    member_generators(generator, B)[i]: the fleet's result is that of one
    process fitting the whole list. The PSNRs are gathered once: each
    rank's slot vector (zero outside its share) is gathered and summed in
    rank order."""
    from implicit_image_tpu_torch.parallel.batched import member_generators
    from implicit_image_tpu_torch.parallel.collectives import AxisGroup
    from implicit_image_tpu_torch.training.fit import fit

    world, pid = dist.get_world_size(), dist.get_rank()
    imgs = np.asarray(imgs)
    b = imgs.shape[0]
    lo, hi = _shard_bounds(b, world, pid)
    gens = member_generators(generator, b)
    grid = grid.to(device)
    slot = torch.zeros(b, dtype=torch.float32, device=device)
    local_params = []
    for i in range(lo, hi):
        res = fit(gens[i], mdef, mcfg, grid, imgs[i], train_cfg, optim_cfg, masking_cfg,
                  device=device)
        p = np.asarray(res.metrics["psnr"]).reshape(-1)
        p = p[np.isfinite(p)]
        slot[i] = float(p[-1]) if p.size else float("nan")
        local_params.append(res.params)
    (total,) = AxisGroup(dist.group.WORLD, range(world), device).sum([slot])
    return total.cpu().numpy(), local_params


def _worker_main(argv: Sequence[str]) -> None:
    """Dryrun worker: join the group, check a global collective, run a small
    fleet and write one JSON report (to --report and stdout)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--fleet-size", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--report", default=None)
    # fault injection: exit uncleanly right after joining the group, leaving
    # the peers blocked in the next collective
    ap.add_argument("--die", action="store_true")
    args = ap.parse_args(argv)

    from implicit_image_tpu_torch.data import get_grid, synthetic_image
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.parallel.collectives import AxisGroup
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig

    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)  # n workers share the machine's cores
    init_multihost(args.init_method, args.num_processes, args.process_id, args.backend, device)
    if args.die:
        os._exit(17)  # a crash: no shutdown, the peers wait in the collective
    if device.type == "cuda":
        from implicit_image_tpu_torch.ops.cuda_build import open_device

        device = open_device(torch.device("cuda", torch.cuda.current_device()))
    world = dist.get_world_size()
    # 1) a global collective over every rank
    (total,) = AxisGroup(dist.group.WORLD, range(world), device).sum(
        [torch.tensor([float(dist.get_rank())], dtype=torch.float64, device=device)])
    expect = world * (world - 1) / 2.0
    if float(total) != expect:
        raise AssertionError(f"global sum {float(total)} != {expect}")
    # 2) a fleet of independent fits, the PSNRs gathered
    hw = 16
    imgs = np.stack([synthetic_image(hw, hw, seed=s) for s in range(args.fleet_size)])
    mdef, mcfg = build_model("siren", depth=3, hidden_size=8)
    fleet_psnrs, _ = fleet_fit(
        torch.Generator().manual_seed(0), mdef, mcfg, get_grid(hw, hw), imgs,
        TrainConfig(num_steps=args.steps, log_steps=args.steps), OptimConfig(lr=1e-3),
        device=device)
    lo, hi = _shard_bounds(args.fleet_size, world, dist.get_rank())
    report = json.dumps({
        "process_id": dist.get_rank(),
        "process_count": world,
        "backend": dist.get_backend(),
        "device": str(device),
        "collective_ok": True,
        "images": [lo, hi],
        "fleet_psnrs": [float(x) for x in fleet_psnrs],
    })
    if args.report:
        Path(args.report).write_text(report + "\n")
    print(report, flush=True)
    dist.barrier()
    dist.destroy_process_group()


def _supervise(codes: Callable[[], list], kill: Callable[[], None], logs: List[Path],
               timeout: float) -> None:
    """Poll the workers' exit codes until all are 0; the first non-zero one
    raises RuntimeError (its log's tail attached), `timeout` seconds without
    an end TimeoutError. Either way the survivors are killed."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            now = codes()
            dead = [i for i, rc in enumerate(now) if rc not in (None, 0)]
            if dead:
                tail = logs[dead[0]].read_text(errors="replace")[-3000:]
                raise RuntimeError(f"worker(s) {dead} exited {[now[i] for i in dead]}; fleet "
                                   f"torn down\nworker {dead[0]} log:\n{tail}")
            if all(rc == 0 for rc in now):
                return
            if time.monotonic() > deadline:
                alive = [i for i, rc in enumerate(now) if rc is None]
                raise TimeoutError(f"no end in {timeout} s; worker(s) {alive} still running "
                                   "- fleet torn down")
            time.sleep(0.1)
    finally:
        kill()


def launch_dryrun(num_processes: int = 2, fleet_size: int = 3, steps: int = 20,
                  timeout: float = 300.0, die_process: Optional[int] = None, device="cuda",
                  backend: Optional[str] = None) -> list:
    """Spawn `num_processes` dryrun workers (module note) on `device`
    ("cuda": each takes LOCAL_RANK modulo the cards; "cpu": gloo) and return
    their parsed reports in rank order. `die_process=p` makes worker p exit
    right after joining the group. The kernels are built here, before any
    worker starts, so that no two processes build them."""
    if torch.device(device).type == "cuda":
        from implicit_image_tpu_torch.ops.cuda_build import open_device

        open_device(device)
    repo = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    tmp = Path(tempfile.mkdtemp(prefix="multihost_dryrun_"))
    reports = [tmp / f"report_{i}.json" for i in range(num_processes)]
    logs = [tmp / f"worker_{i}.log" for i in range(num_processes)]
    procs = []
    for i in range(num_processes):
        cmd = [sys.executable, "-m", "implicit_image_tpu_torch.parallel.multihost",
               "--init-method", f"file://{tmp / 'rendezvous'}",
               "--num-processes", str(num_processes), "--process-id", str(i),
               "--device", str(device), "--fleet-size", str(fleet_size),
               "--steps", str(steps), "--report", str(reports[i])]
        cmd += ["--backend", backend] if backend else []
        cmd += ["--die"] if die_process == i else []
        with open(logs[i], "w") as log:
            procs.append(subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT))

    def kill():
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    _supervise(lambda: [p.poll() for p in procs], kill, logs, timeout)
    out = [json.loads(r.read_text()) for r in reports]
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _group_main(fn, rank: int, world: int, init_method: str, backend, device, args,
                out_path: str, log_path: str) -> None:
    """A run_group worker: output to its log, join the group, run fn, save
    its result (torch.save: tensors on the card load on the host)."""
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the machine's cores
    init_multihost(init_method, world, rank, backend, device)
    out = fn(rank, *args)
    torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()


def run_group(fn: Callable, nprocs: int, args: tuple = (), device="cuda",
              backend: Optional[str] = None, timeout: float = 120.0,
              workdir: Optional[str] = None) -> list:
    """Run fn(rank, *args) in `nprocs` spawned processes joined in one
    process group (init_multihost(device=device, backend=backend), a file://
    rendezvous under `workdir`) and return each rank's result, tensors
    mapped to the host. fn must be importable (a module-level function);
    on the CPU each process runs one thread. A worker that raises makes
    this raise RuntimeError with its log; `timeout` seconds without an end,
    TimeoutError; either way every worker is killed. For device "cuda" the
    caller builds the kernels first (cuda_build.open_device), so that no
    two processes build them."""
    import multiprocessing as mp

    tmp = Path(tempfile.mkdtemp(prefix="group_", dir=workdir))
    outs = [tmp / f"result_{r}.pt" for r in range(nprocs)]
    logs = [tmp / f"rank_{r}.log" for r in range(nprocs)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_group_main,
                         args=(fn, r, nprocs, f"file://{tmp / 'rendezvous'}", backend,
                               str(device), args, str(outs[r]), str(logs[r])))
             for r in range(nprocs)]
    for p in procs:
        p.start()

    def kill():
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join(timeout=10)

    _supervise(lambda: [p.exitcode for p in procs], kill, logs, timeout)
    results = [torch.load(o, map_location="cpu", weights_only=False) for o in outs]
    shutil.rmtree(tmp, ignore_errors=True)
    return results


if __name__ == "__main__":
    if "--dryrun" in sys.argv:
        cli = argparse.ArgumentParser()
        cli.add_argument("--dryrun", type=int, required=True)
        cli.add_argument("--device", default="cuda")
        cli.add_argument("--backend", default=None)
        cli.add_argument("--fleet-size", type=int, default=3)
        cli.add_argument("--steps", type=int, default=20)
        a = cli.parse_args()
        for r in launch_dryrun(a.dryrun, a.fleet_size, a.steps, device=a.device,
                               backend=a.backend):
            print(json.dumps(r))
    else:
        _worker_main(sys.argv[1:])
