"""The QAT finetune at its default in both packages, on a small lattice on
the CPU (a manual check, not collected by pytest).

Both packages' compress.main run the composed default protocol (2,000 fit
steps, RigL at density 0.5 with an update every 20 steps up to step 1,500,
lr 3e-4 StepLR, `plain` container) with quant=qat at its defaults (8 bits,
per-channel, 100 finetune steps: config/conf/quant/qat.yaml), on the
synthetic image at SIDE², SIREN DEPTH/WIDTH. Both start from one meta-init
written by the JAX package and from one saved ERK mask
(masking.sparse_init=lottery-ticket), as tests/rigl_gap_check.py does. Each
package runs again with train.pixel_chunks=2: the same fit and finetune with
another order of the sums, to read the package's own spread.

It prints each run's fit, quant and decoded PSNR and bytes, and for the port
against JAX and each reordered run against its package's: the decoded dB
and bytes apart,
and the share of the stored int8 codes (`labeled_weight`, read from each
container by the JAX package's reader) that differ, over all codes and over
the codes either run keeps nonzero. A run whose record.json exists under
--out is read, not run again.

Then the finetune alone, from one start: each package's quant_finetune, at
pixel_chunks 1 and 2, from the JAX run's fitted weights and final masks (its
model.npz and mask.npz) for --finetune-steps steps each, printing the share
of codes that differ (the port from JAX, each reordered finetune from its
package's) after each count: how the gaps grow with the steps when the fits
do not differ.

    python tests/qat_gap_check.py 64 4 32 --out /tmp/qat_gap
    python tests/qat_gap_check.py 128 6 64 --out /tmp/qat_gap
"""
import argparse
import json
from pathlib import Path

from rigl_gap_check import _run  # noqa: E402 (sets the JAX platform to the CPU)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from implicit_image_tpu import compress as jcompress  # noqa: E402
from implicit_image_tpu.coding import read_raw_container  # noqa: E402
from implicit_image_tpu.config import compose  # noqa: E402
from implicit_image_tpu.data import get_grid as jgrid  # noqa: E402
from implicit_image_tpu.models import build_model as jbuild  # noqa: E402
from implicit_image_tpu.quant import QuantConfig as JQuant  # noqa: E402
from implicit_image_tpu.sparsity import core as jcore  # noqa: E402
from implicit_image_tpu.training.fit import OptimConfig as JOptim  # noqa: E402
from implicit_image_tpu.training.metainit import save_meta_init  # noqa: E402
from implicit_image_tpu.training.quant_phase import quant_finetune as jfinetune  # noqa: E402
from implicit_image_tpu_torch import compress as tcompress  # noqa: E402
from implicit_image_tpu_torch.data import get_grid  # noqa: E402
from implicit_image_tpu_torch.models import build_model  # noqa: E402
from implicit_image_tpu_torch.quant import QuantConfig  # noqa: E402
from implicit_image_tpu_torch.training.quant_phase import quant_finetune  # noqa: E402


# (run, the run it is held against): the port against JAX, and each
# package's reordered run against its own
PAIRS = (("torch", "jax"), ("jax_chunks2", "jax"), ("torch_chunks2", "torch"))


def _codes(run_dir: Path) -> dict:
    """The container's int8 codes per layer and its qscales."""
    cfg = json.loads((run_dir / "config.json").read_text())
    raw = read_raw_container(run_dir / "model_quantized", cfg["entropy_coding"]["stream_name"])
    return {k: np.asarray(v) for k, v in raw.items() if "labeled_weight" in k or "qscale" in k}


def _apart(ours: dict, theirs: dict) -> dict:
    """Codes that differ, over all codes and over those either keeps
    nonzero; the largest code step apart; qscales' largest relative gap."""
    names = sorted(k for k in theirs if "labeled_weight" in k)
    assert names == sorted(k for k in ours if "labeled_weight" in k), (list(ours), list(theirs))
    a = np.concatenate([ours[k].astype(np.int64).ravel() for k in names])
    b = np.concatenate([theirs[k].astype(np.int64).ravel() for k in names])
    kept = (a != 0) | (b != 0)
    diff = a != b
    scales = [np.abs(ours[k].astype(np.float64) - theirs[k]).max() / np.abs(theirs[k]).max()
              for k in theirs if "qscale" in k]
    return {"codes": int(a.size), "differ": float(diff.mean()),
            "differ_kept": float(diff[kept].mean()), "kept": int(kept.sum()),
            "max_step": int(np.abs(a - b).max()), "qscale_rel": float(max(scales))}


def _finetune_alone(run_dir: Path, overrides, steps: int) -> dict:
    """Per-layer (codes, scales) after `steps` QAT steps from run_dir's
    fitted weights and masks, by run name (those of `PAIRS`)."""
    cfg = compose(overrides)
    model, masks = np.load(run_dir / "model.npz"), np.load(run_dir / "mask.npz")
    depth = int(cfg.mlp.depth)
    params = [{k: model[f"layers.{i}.{k}"] for k in ("w", "b")} for i in range(depth)]
    mask = [masks[f"layers.{i}.mask"] if f"layers.{i}.mask" in masks.files else None
            for i in range(depth)]
    img = jcompress._load_image(cfg.img)
    side = int(cfg.img.height)
    optim = tcompress._optim_config(cfg)
    jquant = JQuant(name="QAT", bits=int(cfg.quant.bits), num_steps=steps,
                    qscheme=str(cfg.quant.qscheme))
    jdef, jcfg = jbuild("siren", depth=depth, hidden_size=int(cfg.mlp.hidden_size))
    jopt = JOptim(**{k: v for k, v in optim.__dict__.items()
                     if k in JOptim.__dataclass_fields__})
    out = {}
    for name, chunks in (("jax", 1), ("jax_chunks2", 2)):
        res = jfinetune(
            tuple({k: jax.numpy.asarray(v) for k, v in layer.items()} for layer in params), img,
            jdef, jcfg, jgrid(side, side), jquant, jopt,
            masks=[None if m is None else jax.numpy.asarray(m) for m in mask],
            pixel_chunks=chunks, matmul_precision=cfg.train.get("matmul_precision") or None)
        out[name] = [None if b is None else (np.asarray(b.codes), np.asarray(b.scales))
                     for b in res.codebooks]
    tdef, tcfg = build_model("siren", depth=depth, hidden_size=int(cfg.mlp.hidden_size))
    for name, chunks in (("torch", 1), ("torch_chunks2", 2)):
        res = quant_finetune(
            [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in params], img, tdef,
            tcfg, get_grid(side, side),
            QuantConfig(name="QAT", bits=int(cfg.quant.bits), num_steps=steps,
                        qscheme=str(cfg.quant.qscheme)),
            optim, precision="fp32", pixel_chunks=chunks,
            masks=[None if m is None else torch.from_numpy(m) for m in mask])
        out[name] = [None if b is None else (b.codes.numpy(), b.scales.numpy())
                     for b in res.codebooks]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", type=int)
    ap.add_argument("depth", type=int)
    ap.add_argument("width", type=int)
    ap.add_argument("--out", default="outputs/qat_gap")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--finetune-steps", default="1,5,10,25,50,100")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    root = Path(args.out) / f"{args.side}_{args.depth}_{args.width}" / f"seed{args.seed}"
    root.mkdir(parents=True, exist_ok=True)
    if not (root / "mask.npz").exists():
        mdef, mcfg = jbuild("siren", depth=args.depth, hidden_size=args.width)
        params = mdef.init(jax.random.PRNGKey(11 + 2 * args.seed), mcfg)
        save_meta_init(root / "init.npz", params, "siren", mcfg)
        masks = jcore.create_mask_state(jax.random.PRNGKey(12 + 2 * args.seed), params,
                                        jcore.MaskingConfig(density=0.5)).masks
        np.savez(root / "mask.npz", **{f"layers.{i}.mask": np.asarray(m)
                                       for i, m in enumerate(masks) if m is not None})

    base = ["img=synthetic", f"img.height={args.side}", f"img.width={args.side}",
            f"mlp.depth={args.depth}", f"mlp.hidden_size={args.width}", "train.log_steps=100",
            f"train.init_path={root / 'init.npz'}", "masking.sparse_init=lottery-ticket",
            f"masking.mask_path={root / 'mask.npz'}", "quant=qat"]
    runs = {"jax": (jcompress.main, []), "torch": (tcompress.main, ["device=cpu"]),
            "jax_chunks2": (jcompress.main, ["train.pixel_chunks=2"]),
            "torch_chunks2": (tcompress.main, ["device=cpu", "train.pixel_chunks=2"])}
    recs, codes = {}, {}
    for name, (main_fn, extra) in runs.items():
        run_dir = root / name
        record = run_dir / "record.json"
        if record.exists():
            rec = json.loads(record.read_text())
        else:
            rec = _run(main_fn, base + extra, run_dir)
            rec["quant"] = json.loads((run_dir / "summary.json").read_text())["Quant PSNR"]
            record.write_text(json.dumps(rec))
        recs[name], codes[name] = rec, _codes(run_dir)
        print(f"{name}: fit {rec['fit']:.3f} dB, quant {rec['quant']:.3f} dB, decoded "
              f"{rec['decoded']:.3f} dB, {rec['bytes']} B, {rec['seconds']:.1f} s", flush=True)
    out = {"runs": recs}
    for name, ref in PAIRS:
        gap = _apart(codes[name], codes[ref])
        gap["decoded_db"] = recs[name]["decoded"] - recs[ref]["decoded"]
        gap["bytes"] = recs[name]["bytes"] - recs[ref]["bytes"]
        out[f"{name}-{ref}"] = gap
        print(f"{name} - {ref}: decoded {gap['decoded_db']:+.3f} dB, bytes {gap['bytes']:+d}; "
              f"codes differing {gap['differ']:.4%} of {gap['codes']} "
              f"({gap['differ_kept']:.4%} of the {gap['kept']} kept nonzero by either), "
              f"largest step {gap['max_step']}; qscale max rel gap {gap['qscale_rel']:.2e}",
              flush=True)
    alone = {}
    for steps in [int(x) for x in args.finetune_steps.split(",")]:
        got = _finetune_alone(root / "jax", base, steps)
        codes = {n: {f"layers.{i}.{key}": c[j] for i, c in enumerate(v) if c is not None
                     for j, key in enumerate(("labeled_weight", "qscale"))}
                 for n, v in got.items()}
        alone[steps] = {f"{n}-{ref}": _apart(codes[n], codes[ref]) for n, ref in PAIRS}
        print(f"finetune alone, {steps} steps from the JAX fit: codes differing: "
              + "; ".join(f"{n} {g['differ']:.4%} (largest step {g['max_step']}, scales "
                          f"{g['qscale_rel']:.1e})" for n, g in alone[steps].items()), flush=True)
    out["finetune_alone"] = alone
    (root / "gap.json").write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
