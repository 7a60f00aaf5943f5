"""The mixed-precision-minus-fp32 gap of the default protocol in both
packages, on a small lattice on the CPU (a manual check, not collected by
pytest).

Both packages' compress.main run the composed default protocol (2,000 fit
steps, RigL at density 0.5 with an update every 20 steps up to step 1,500,
lr 3e-4 StepLR, k-means-8 finetune, `plain` container) with and without
train.mixed_precision, on the synthetic image at SIDE², SIREN DEPTH/WIDTH.
Both start from one meta-init written by the JAX package and from one saved
ERK mask (masking.sparse_init=lottery-ticket), as tests/rigl_gap_check.py
does. It prints each run's fit and decoded PSNR with the fit PSNR at every
100th step, and each package's gap (mixed - fp32, decoded). With
--jax-pixel-chunks K it also runs the JAX package with train.pixel_chunks=K:
the same fits with another order of the sums, to read the package's own
spread.

--seeds runs the check once per seed (seed s draws the meta-init and the
mask from keys 11 + 2s and 12 + 2s) and prints, per package, the gaps over
the seeds with their mean and spread (max - min), and per seed the
difference of each gap from JAX's. A run whose record.json exists under
--out is read, not run again, so seeds can run in separate processes and a
last call with all of them prints the summary.

    python tests/mixed_gap_check.py 64 4 32 --out /tmp/mixed_gap --seeds 0,1,2
    python tests/mixed_gap_check.py 128 6 64 --out /tmp/mixed_gap --seeds 1 \\
        --jax-pixel-chunks 2
"""
import argparse
import json
from pathlib import Path

from rigl_gap_check import _run  # noqa: E402 (sets the JAX platform to the CPU)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from implicit_image_tpu import compress as jcompress  # noqa: E402
from implicit_image_tpu.models import build_model as jbuild  # noqa: E402
from implicit_image_tpu.sparsity import core as jcore  # noqa: E402
from implicit_image_tpu.training.metainit import save_meta_init  # noqa: E402
from implicit_image_tpu_torch import compress as tcompress  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", type=int)
    ap.add_argument("depth", type=int)
    ap.add_argument("width", type=int)
    ap.add_argument("--out", default="outputs/mixed_gap")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--jax-pixel-chunks", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    size = f"{args.side}_{args.depth}_{args.width}"
    gaps = {seed: check(args, Path(args.out) / size / f"seed{seed}", seed)
            for seed in [int(x) for x in args.seeds.split(",")]}
    summary = {}
    for name in [k[: -len("/gap")] for k in gaps[next(iter(gaps))] if k.endswith("/gap")]:
        vals = [g[f"{name}/gap"] for g in gaps.values()]
        summary[name] = {"gaps": vals, "mean": float(np.mean(vals)),
                         "spread": max(vals) - min(vals)}
        print(f"{size} {name} gaps over seeds {list(gaps)}: "
              f"{' '.join(f'{v:.3f}' for v in vals)} dB; mean {summary[name]['mean']:.3f}, "
              f"spread {summary[name]['spread']:.3f} dB", flush=True)
        if name != "jax":
            diffs = [g[f"{name}/gap"] - g["jax/gap"] for g in gaps.values()]
            summary[name]["minus_jax"] = diffs
            print(f"{size} {name} gap - jax gap per seed: "
                  f"{' '.join(f'{v:.3f}' for v in diffs)} dB; mean "
                  f"{float(np.mean(diffs)):.3f} dB", flush=True)
    return summary


def check(args, root: Path, seed: int) -> dict:
    """One seed's runs: each package with and without mixed precision."""
    root.mkdir(parents=True, exist_ok=True)
    if not (root / "mask.npz").exists():
        mdef, mcfg = jbuild("siren", depth=args.depth, hidden_size=args.width)
        params = mdef.init(jax.random.PRNGKey(11 + 2 * seed), mcfg)
        save_meta_init(root / "init.npz", params, "siren", mcfg)
        masks = jcore.create_mask_state(jax.random.PRNGKey(12 + 2 * seed), params,
                                        jcore.MaskingConfig(density=0.5)).masks
        np.savez(root / "mask.npz", **{f"layers.{i}.mask": np.asarray(m)
                                       for i, m in enumerate(masks) if m is not None})

    base = ["img=synthetic", f"img.height={args.side}", f"img.width={args.side}",
            f"mlp.depth={args.depth}", f"mlp.hidden_size={args.width}", "train.log_steps=100",
            f"train.init_path={root / 'init.npz'}", "masking.sparse_init=lottery-ticket",
            f"masking.mask_path={root / 'mask.npz'}"]
    arms = {"fp32": [], "mixed": ["train.mixed_precision=true"]}
    runs = {"jax": (jcompress.main, []), "torch": (tcompress.main, ["device=cpu"])}
    if args.jax_pixel_chunks:
        runs[f"jax_chunks{args.jax_pixel_chunks}"] = (
            jcompress.main, [f"train.pixel_chunks={args.jax_pixel_chunks}"])
    out = {}
    for name, (main_fn, extra) in runs.items():
        for arm, ov in arms.items():
            run_dir = root / f"{name}_{arm}"
            record = run_dir / "record.json"
            if record.exists():
                rec = json.loads(record.read_text())
            else:
                rec = _run(main_fn, base + ov + extra, run_dir)
                record.write_text(json.dumps(rec))
            out[f"{name}/{arm}"] = rec
            print(f"seed {seed} {name} {arm}: fit {rec['fit']:.3f} dB, decoded "
                  f"{rec['decoded']:.3f} dB, {rec['bytes']} B, {rec['seconds']:.1f} s; fit PSNR "
                  f"per 100 steps {rec['trajectory']}", flush=True)
        gap = out[f"{name}/mixed"]["decoded"] - out[f"{name}/fp32"]["decoded"]
        out[f"{name}/gap"] = gap
        print(f"seed {seed} {name} gap (mixed - fp32, decoded): {gap:.3f} dB", flush=True)
    (root / "gap.json").write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
