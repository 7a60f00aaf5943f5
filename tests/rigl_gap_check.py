"""The RigL-minus-dense gap of the default protocol in both packages, on a
small lattice on the CPU (a manual check, not collected by pytest).

Both packages' compress.main run the composed default protocol (2,000 fit
steps, RigL at density 0.5 with an update every 20 steps up to step 1,500,
lr 3e-4 StepLR, k-means-8 finetune, `plain` container) and the same with
masking=none, on the synthetic image at SIDE², SIREN DEPTH/WIDTH. Both start
from one meta-init written by the JAX package, and RigL from one saved ERK
mask (masking.sparse_init=lottery-ticket). It prints each run's fit and
decoded PSNR with the fit PSNR at every 100th step, and each package's gap.
With --jax-pixel-chunks K it also runs the JAX package with
train.pixel_chunks=K: the same fit with another order of the sums, to read
the package's own spread.

    python tests/rigl_gap_check.py 64 4 32 --out /tmp/gap
    python tests/rigl_gap_check.py 128 6 64 --out /tmp/gap --jax-pixel-chunks 2
"""
import argparse
import json
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from implicit_image_tpu import compress as jcompress  # noqa: E402
from implicit_image_tpu.config import compose  # noqa: E402
from implicit_image_tpu.models import build_model as jbuild  # noqa: E402
from implicit_image_tpu.sparsity import core as jcore  # noqa: E402
from implicit_image_tpu.training.metainit import save_meta_init  # noqa: E402
from implicit_image_tpu_torch import compress as tcompress  # noqa: E402


def _run(main, overrides, run_dir: Path):
    t0 = time.perf_counter()
    decoded, nbytes = main(compose(overrides), run_dir=str(run_dir))
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    trajectory = [round(x["PSNR"], 3) for x in lines if x.get("prefix") == "Train"]
    fit_psnr = json.loads((run_dir / "summary.json").read_text())["PSNR"]
    return {"fit": fit_psnr, "decoded": decoded, "bytes": nbytes,
            "seconds": time.perf_counter() - t0, "trajectory": trajectory}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", type=int)
    ap.add_argument("depth", type=int)
    ap.add_argument("width", type=int)
    ap.add_argument("--out", default="outputs/rigl_gap")
    ap.add_argument("--jax-pixel-chunks", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    root = Path(args.out) / f"{args.side}_{args.depth}_{args.width}"
    root.mkdir(parents=True, exist_ok=True)

    mdef, mcfg = jbuild("siren", depth=args.depth, hidden_size=args.width)
    params = mdef.init(jax.random.PRNGKey(11), mcfg)
    save_meta_init(root / "init.npz", params, "siren", mcfg)
    masks = jcore.create_mask_state(jax.random.PRNGKey(12), params,
                                    jcore.MaskingConfig(density=0.5)).masks
    np.savez(root / "mask.npz", **{f"layers.{i}.mask": np.asarray(m)
                                   for i, m in enumerate(masks) if m is not None})
    n_params = sum(int(np.prod(v.shape)) for layer in params for v in layer.values())
    print(f"{n_params} parameters, {args.side ** 2 * 3} pixel values", flush=True)

    base = ["img=synthetic", f"img.height={args.side}", f"img.width={args.side}",
            f"mlp.depth={args.depth}", f"mlp.hidden_size={args.width}", "train.log_steps=100",
            f"train.init_path={root / 'init.npz'}"]
    arms = {"dense": ["masking=none"],
            "rigl": ["masking.sparse_init=lottery-ticket", f"masking.mask_path={root / 'mask.npz'}"]}
    runs = {"jax": (jcompress.main, []), "torch": (tcompress.main, ["device=cpu"])}
    if args.jax_pixel_chunks:
        runs[f"jax_chunks{args.jax_pixel_chunks}"] = (
            jcompress.main, [f"train.pixel_chunks={args.jax_pixel_chunks}"])
    out = {}
    for name, (main_fn, extra) in runs.items():
        for arm, ov in arms.items():
            rec = _run(main_fn, base + ov + extra, root / f"{name}_{arm}")
            out[f"{name}/{arm}"] = rec
            print(f"{name} {arm}: fit {rec['fit']:.3f} dB, decoded {rec['decoded']:.3f} dB, "
                  f"{rec['bytes']} B, {rec['seconds']:.1f} s; fit PSNR per 100 steps "
                  f"{rec['trajectory']}", flush=True)
        gap = out[f"{name}/rigl"]["decoded"] - out[f"{name}/dense"]["decoded"]
        out[f"{name}/gap"] = gap
        print(f"{name} gap (RigL - dense, decoded): {gap:.3f} dB", flush=True)
    (root / "gap.json").write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
