"""Sequence (video) coding CLI (counterpart of implicit_image_tpu/sequence.py):
inter-frame compression of a sequence of images with one coordinate MLP per
frame.

    python -m implicit_image_tpu_torch.sequence sequence.video=<name> quant=kmeans \\
        entropy_coding=auto [sequence.frames=8] [sequence.motion=0.01] \\
        [sequence.steps0=...] [sequence.steps=...] [sequence.gop=0] \\
        [sequence.stop_at_psnr=...] [sequence.lr=1e-4] [sequence.max_drop=3] [overrides...]
    python -m implicit_image_tpu_torch.sequence sequence.files=f0.png,f1.png,... quant=kmeans
    python -m implicit_image_tpu_torch.sequence pack <seq_dir> [out.iiv]
    python -m implicit_image_tpu_torch.sequence decode <seq_dir|file.iiv> [frame=t] [device=cpu]

A sequence is coded as
  * I-frames: frame 0 (and every `sequence.gop`-th frame when gop > 0)
    through the single-image protocol: the fit (training.fit.fit, warm from
    train.init_path when set), the k-means codebook finetune, the container;
    under quant.delta with train.init_path, residual codebooks and XOR
    residuals against that artifact;
  * P-frames: every other frame's fit starts from the PREVIOUS frame's
    DECODED params (so encoder and decoder stay in sync) with a fresh
    optimizer at `sequence.lr` (default 1e-4); under sparsity its masks are
    the decoded nonzeros (`sparse_init=resume`) and stay frozen
    (`end_when=-1`); its quantized layers code residual codebooks against
    the previous decoded weights, its other tensors XOR residuals against
    the previous decoded state, and its manifest records `prev` and the
    previous payload's sha256 (coding.delta_meta_entry);
  * the scene-cut guard (`sequence.max_drop`, default 3 dB; `none`
    disables): a P-frame that decodes more than max_drop below the last
    I-frame is re-encoded as an I-frame in the same frame dir, and its wall
    counts the attempt that was thrown away.
`sequence.stop_at_psnr` stops a P-fit at the first boundary (every
min(segment, max(steps // 4, 25)) steps) where its fit PSNR, read in the
bf16 mode as the fit's own stop check, reaches the target.

The JAX package draws each I-frame's init from PRNGKey(seed + 7919 t) and
splits one key per P-frame from PRNGKey(seed + 1); here each I-frame's fit
draws from torch.Generator seeded seed + 7919 t, and the P-frames share one
generator seeded seed + 1. The two packages' draws differ, so their encodes
agree only from fixed inits (masking=none with train.init_path).

Each frame gets a run dir, <output_dir>/seq_<name>/frame_<t>/, with
config.json, summary.json and model_quantized/, which either package's
decoder reads (decompress.decode_run walks a P-frame's chain itself), and
the sequence a seq_summary.json with the JAX package's keys. Frames render
in the kernels' fp32 mode, the decoder's; the max_drop guard reads that
render. `decode_sequence` decodes a seq dir or an .iiv file
(coding/container_file.py): all frames in O(T), each from the state just
decoded, or one frame by a GOP seek from the nearest I-frame.

Entry points run on the card (`device`, default "cuda": RuntimeError
without one; a `device=cpu` override or device="cpu" runs the plain
versions).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from implicit_image_tpu_torch.config import DotDict, compose
from implicit_image_tpu_torch.utils import catch_error_decorator

log = logging.getLogger("implicit_image_tpu_torch")

__all__ = ["encode_sequence", "decode_sequence", "cli"]


def _load_frames(cfg) -> Tuple[np.ndarray, str]:
    """(frames (T, H, W, 3) float32 in [0, 1], the sequence's name).
    `sequence.files=a,b,c` loads image files through compress.py's loader;
    `sequence.video=<name>` is the seeded synthetic sequence
    (data.synthetic_video, seeded by the name) at img.height x img.width,
    `sequence.frames` frames at `sequence.motion`."""
    from implicit_image_tpu_torch.compress import _load_image
    from implicit_image_tpu_torch.data import stable_seed, synthetic_video

    seq = cfg.get("sequence") or {}
    files = seq.get("files")
    if files:
        entries = ([str(e) for e in files] if isinstance(files, (list, tuple))
                   else str(files).split(","))
        frames = []
        for e in entries:
            img_cfg = DotDict(dict(cfg.img))
            img_cfg["path"] = e
            img_cfg["name"] = Path(e).stem
            frames.append(_load_image(img_cfg))
        return np.stack(frames).astype(np.float32), Path(entries[0]).stem
    name = str(seq.get("video", "seq"))
    h = int(cfg.img.get("height", 256))
    w = int(cfg.img.get("width", 256))
    t = int(seq.get("frames", 8))
    motion = float(seq.get("motion", 0.01))
    return synthetic_video(h, w, t, seed=stable_seed(name), motion=motion), name


def _payload_sha(frame_dir: Path) -> str:
    return hashlib.sha256((frame_dir / "compressed_weights.data").read_bytes()).hexdigest()


def _renderer(mdef, mcfg, grid):
    """render(params) -> (H, W, 3) numpy image in the kernels' fp32 mode."""
    def render(params):
        with torch.no_grad():
            return mdef.apply(params, grid, mcfg, "fp32").cpu().numpy()

    return render


class _Coded(NamedTuple):
    """One coded frame: its container's parent dir, bytes, decoded state
    (float32 arrays) and params (tensors on the device), its fit's result
    and the steps the fit ran."""

    dir: Path
    nbytes: int
    state: Dict[str, np.ndarray]
    params: tuple
    fit: object
    steps: int


class _FrameCoder:
    """What every frame of a sequence is coded with, from a composed config
    (its img.height / width the frames'): the model, the fit and finetune
    configs of I- and P-frames, the stream. It opens the device (the
    kernels build here, before any frame's wall). `iframe` and `pframe`
    each fit, finetune, write and decode one frame."""

    def __init__(self, cfg, device="cuda"):
        from implicit_image_tpu_torch.parallel.ladder import build_ladder_args

        # the grid is that of cfg.img's image, loaded at img.height x width
        args = build_ladder_args(DotDict({**cfg, "device": cfg.get("device", device)}))
        self.cfg, self.device = cfg, args["device"]
        self.mdef, self.mcfg, self.grid = args["mdef"], args["mcfg"], args["grid"]
        train_cfg, self.optim_cfg = args["train_cfg"], args["optim_cfg"]
        self.quant_cfg = args["quant_cfg"]
        if self.quant_cfg is None or self.quant_cfg.name != "KMeans":
            raise ValueError("sequence encoding requires quant=kmeans (P-frames delta-code "
                             "residual codebooks; uniform QAT has no residual form)")
        self.stream, self.half = args["stream_name"], args["half"]
        self.coding_kwargs = args["coding_kwargs"]
        self.masking = args["masking"]
        self.sparse = self.masking is not None and not self.masking.dense
        # quant.delta + train.init_path: I-frames code residuals against the
        # shared artifact; P-frames code against the previous frame
        self.init_params, self.iframe_delta = args["init_params"], args["delta_info"]
        self.precision = train_cfg.precision
        self.render = _renderer(self.mdef, self.mcfg, self.grid)

        seq = cfg.get("sequence") or {}
        self.steps0 = int(seq.get("steps0", train_cfg.num_steps))
        self.steps_p = int(seq.get("steps", max(train_cfg.num_steps // 4, 1)))
        stop_db = seq.get("stop_at_psnr")
        self.stop_db = float(stop_db) if stop_db is not None else None
        self.i_train = dataclasses.replace(train_cfg, num_steps=self.steps0)
        # P-fits: warm from the previous decoded params, a fresh optimizer at
        # sequence.lr, the masks the decoded nonzeros, frozen (the cadence
        # never fires)
        self.p_optim_cfg = dataclasses.replace(self.optim_cfg, lr=float(seq.get("lr", 1e-4)))
        self.p_masking = (dataclasses.replace(self.masking, sparse_init="resume", end_when=-1,
                                              mask_path=None) if self.sparse else None)
        seg = max(1, train_cfg.segment_steps)
        if self.stop_db is not None:
            # finer boundaries, so the early stop has granularity
            seg = min(seg, max(self.steps_p // 4, 25))
        self.p_train = dataclasses.replace(train_cfg, num_steps=self.steps_p, segment_steps=seg)

    def _code(self, res, img, frame_dir: Path, offsets, delta, ref_map, prev_state, steps):
        """The finetune, the container (its XOR residuals against `ref_map`
        when given) and its decode."""
        from implicit_image_tpu_torch.coding import (
            apply_xor_residual,
            compress_state_dict,
            decompress_state_dict,
            linear_state_dict,
            params_from_state_dict,
        )
        from implicit_image_tpu_torch.training.quant_phase import quant_finetune

        qres = quant_finetune(res.params, img, self.mdef, self.mcfg, self.grid, self.quant_cfg,
                              self.optim_cfg, precision=self.precision,
                              masks=res.mask_state.masks if self.sparse else None,
                              offset_params=offsets)
        state = linear_state_dict(qres.params, qres.codebooks, half=self.half)
        if delta is not None:
            delta["layers"] = [i for i, cb in enumerate(qres.codebooks) if cb is not None]
            state, delta["xor"] = apply_xor_residual(state, ref_map)
        container = frame_dir / "model_quantized"
        nbytes = compress_state_dict(state, container, self.stream, delta=delta,
                                     **self.coding_kwargs)
        dec_state = decompress_state_dict(container, self.stream, prev_state=prev_state)
        return _Coded(frame_dir, nbytes, dec_state,
                      params_from_state_dict(dec_state, self.device), res, steps)

    def iframe(self, t: int, img, frame_dir: Path) -> _Coded:
        """The single-image protocol on frame t, its fit's draws from a
        generator seeded seed + 7919 t."""
        from implicit_image_tpu_torch.coding import state_ref_map
        from implicit_image_tpu_torch.training.fit import fit

        res = fit(torch.Generator().manual_seed(int(self.cfg.seed) + 7919 * t), self.mdef,
                  self.mcfg, self.grid, img, self.i_train, self.optim_cfg, self.masking,
                  init_params=self.init_params, device=self.device)
        if self.iframe_delta is None:
            return self._code(res, img, frame_dir, None, None, None, None, self.steps0)
        return self._code(res, img, frame_dir, self.init_params, dict(self.iframe_delta),
                          state_ref_map(self.init_params), None, self.steps0)

    def pframe(self, img, prev: _Coded, frame_dir: Path, generator) -> _Coded:
        """A P-frame from the previous coded frame `prev` (its decoded params
        the fit's init and the finetune's offsets, its decoded state the XOR
        reference); the fit's draws from `generator`."""
        from implicit_image_tpu_torch.training.fit import fit

        res = fit(generator, self.mdef, self.mcfg, self.grid, img, self.p_train,
                  self.p_optim_cfg, self.p_masking, init_params=prev.params, device=self.device,
                  stop_psnr=self.stop_db)
        delta = {"prev": f"../../{prev.dir.name}/model_quantized",
                 "sha256": _payload_sha(prev.dir / "model_quantized"), "stream": self.stream}
        return self._code(res, img, frame_dir, prev.params, delta, prev.state, prev.state,
                          res.stopped_at if res.stopped_at is not None else self.steps_p)


def encode_sequence(argv, device="cuda", renders: Optional[dict] = None) -> List[dict]:
    """Encode a sequence; returns the per-frame rows (frame, kind, steps,
    decoded_psnr, bytes, wall_s). argv: compress.py-style overrides (module
    note); a `device=` override beats `device`. `renders`, when given,
    receives each frame's decoded render, the image its decoded_psnr reads,
    under the frame's name."""
    from implicit_image_tpu_torch.training.fit import synchronize

    cfg = compose(list(argv))
    frames, seq_name = _load_frames(cfg)
    t_total, h, w = frames.shape[:3]
    # the geometry is the frames' own (files may differ from the img group)
    cfg["img"]["height"], cfg["img"]["width"] = int(h), int(w)
    coder = _FrameCoder(cfg, device)
    seq = cfg.get("sequence") or {}
    gop = int(seq.get("gop", 0))  # an I-frame every gop frames; 0: frame 0 only
    max_drop = seq.get("max_drop", 3.0)
    if isinstance(max_drop, str) and max_drop.lower() in ("none", "null", ""):
        max_drop = None
    max_drop = float(max_drop) if max_drop is not None else None
    root = Path(cfg.get("output_dir", "outputs")) / f"seq_{seq_name}"
    root.mkdir(parents=True, exist_ok=True)

    results: List[dict] = []
    last: Dict[str, object] = {}  # the previous coded frame; the last I-frame's PSNR

    def finish(coded: _Coded, kind: str, t0: float, dec_img, db: float) -> None:
        last.update(prev=coded)
        if kind == "I":
            last["i_psnr"] = db
        results.append(_finish_frame(cfg, coded.dir, db, coded.nbytes, coder.stream,
                                     wall=time.perf_counter() - t0, kind=kind,
                                     steps=coded.steps))
        if renders is not None:
            renders[coded.dir.name] = dec_img

    def encode_iframe(t: int, t0: float) -> None:
        coded = coder.iframe(t, frames[t], root / f"frame_{t:04d}")
        finish(coded, "I", t0, *_render_psnr(coder.render, coded.params, frames[t]))

    synchronize(coder.device)
    encode_iframe(0, time.perf_counter())
    p_generator = torch.Generator().manual_seed(int(cfg.seed) + 1)
    for t in range(1, t_total):
        synchronize(coder.device)
        t0 = time.perf_counter()
        if gop > 0 and t % gop == 0:
            encode_iframe(t, t0)
            continue
        coded = coder.pframe(frames[t], last["prev"], root / f"frame_{t:04d}", p_generator)
        dec_img, db = _render_psnr(coder.render, coded.params, frames[t])
        if max_drop is not None and db < float(last["i_psnr"]) - max_drop:
            # the quality floor is breached: the short warm P-fit cannot
            # track this much motion; the I-frame overwrites the frame dir,
            # and its wall counts the P attempt
            log.info("frame %d: P decoded %.2f dB > %.1f dB below the last I-frame (%.2f) — "
                     "falling back to an I-frame", t, db, max_drop, float(last["i_psnr"]))
            encode_iframe(t, t0)
            continue
        finish(coded, "P", t0, dec_img, db)

    total_bytes = sum(r["bytes"] for r in results)
    summary = {
        "frames": t_total,
        "total_bytes": total_bytes,
        "bytes_per_frame": round(total_bytes / t_total, 1),
        "mean_decoded_psnr": round(float(np.mean([r["decoded_psnr"] for r in results])), 2),
        "gop": gop,
        "steps0": coder.steps0,
        "steps": coder.steps_p,
        "rows": results,
    }
    (root / "seq_summary.json").write_text(json.dumps(summary, indent=2))
    log.info("SEQUENCE %s: %d frames, %d bytes total (%.1f/frame), mean decoded %.2f dB",
             seq_name, t_total, total_bytes, total_bytes / t_total,
             summary["mean_decoded_psnr"])
    return results


def _render_psnr(render, dec_params, img):
    """(decoded frame, PSNR dB) of decoded params against the source."""
    dec = np.asarray(render(dec_params))
    mse = float(np.mean((dec - np.asarray(img, np.float32)) ** 2))
    return dec, float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def _finish_frame(cfg, frame_dir: Path, psnr: float, nbytes: int, stream: str, wall: float,
                  kind: str, steps: int) -> dict:
    """Write the frame's config.json (the stream it was written with) and
    summary.json, print its JSON row and return it; `psnr` is its decoded
    render's."""
    frame_dir.mkdir(parents=True, exist_ok=True)
    frame_cfg = json.loads(json.dumps(dict(cfg), default=str))
    frame_cfg.setdefault("entropy_coding", {})
    if not isinstance(frame_cfg["entropy_coding"], dict):
        frame_cfg["entropy_coding"] = {}
    frame_cfg["entropy_coding"]["stream_name"] = stream
    (frame_dir / "config.json").write_text(json.dumps(frame_cfg, indent=2, default=str))
    row = {
        "frame": frame_dir.name,
        "kind": kind,
        "steps": steps,
        "decoded_psnr": round(psnr, 2),
        "bytes": int(nbytes),
        "wall_s": round(wall, 3),
    }
    (frame_dir / "summary.json").write_text(json.dumps({
        "Decoded PSNR": row["decoded_psnr"],
        "Compressed Bytes": row["bytes"],
        "Frame Kind": kind,
    }, indent=2))
    print(json.dumps(row), flush=True)
    return row


def decode_sequence(root, stream: Optional[str] = None, frame: Optional[int] = None,
                    device="cuda", stats: Optional[dict] = None):
    """Decode a seq_* dir or a packed .iiv file on `device`.

    frame=None: every frame in O(T), each frame's offsets the frame just
    decoded (every link's sha256 still checked); returns (frames (T, H, W,
    3) float32, frame dir names). frame=t: a GOP seek from the nearest
    I-frame at or before t (kinds from the manifests' `prev` links; an .iiv
    extracts only that chain); returns ((H, W, 3) float32, frame name).
    `stats`, when given, receives "frame_s": the seconds of each frame's
    host decode, upload, render and copy back, in decode order."""
    from implicit_image_tpu_torch.coding import decompress_state_dict, params_from_state_dict
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.ops.cuda_build import open_device
    from implicit_image_tpu_torch.training.fit import synchronize

    root = Path(root)
    if root.is_file():
        import tempfile

        from implicit_image_tpu_torch.coding.container_file import (
            read_sequence_index,
            unpack_sequence,
        )

        needed = None
        if frame is not None:
            frames_idx = read_sequence_index(root)["frames"]
            t = int(frame)
            if not 0 <= t < len(frames_idx):
                raise IndexError(f"frame {t} out of range (sequence has {len(frames_idx)})")
            start = t
            while start > 0 and frames_idx[start]["kind"] != "I":
                start -= 1
            needed = [f["name"] for f in frames_idx[start: t + 1]]
            # the extracted dir holds only the chain: the seek's position in it
            frame = t - start
        with tempfile.TemporaryDirectory() as tmp:
            seq_dir = unpack_sequence(root, Path(tmp) / root.stem, frames=needed)
            return decode_sequence(seq_dir, stream, frame, device, stats)
    device = open_device(device)
    frame_dirs = sorted(d for d in root.iterdir() if d.is_dir() and d.name.startswith("frame_"))
    if not frame_dirs:
        raise FileNotFoundError(f"no frame_* dirs under {root}")
    cfg = json.loads((frame_dirs[0] / "config.json").read_text())
    if stream is None:
        stream = cfg.get("entropy_coding", {}).get("stream_name", "zstd")
    mdef, mcfg = build_model_from_config(cfg)
    h, w = int(cfg["img"]["height"]), int(cfg["img"]["width"])
    render = _renderer(mdef, mcfg, get_grid(h, w, device))
    times = []

    def decode(d, prev_state):
        t0 = time.perf_counter()
        state = decompress_state_dict(d / "model_quantized", stream, prev_state=prev_state)
        img = render(params_from_state_dict(state, device))
        synchronize(device)
        times.append(time.perf_counter() - t0)
        return state, img

    if frame is not None:
        t = int(frame)
        if not 0 <= t < len(frame_dirs):
            raise IndexError(f"frame {t} out of range (sequence has {len(frame_dirs)})")

        def is_iframe(d: Path) -> bool:
            meta = json.loads((d / "model_quantized" / "meta_data.json").read_text())
            return "prev" not in meta.get("__meta__", {}).get("delta", {})

        start = t
        while start > 0 and not is_iframe(frame_dirs[start]):
            start -= 1
        prev_state = None
        for d in frame_dirs[start: t]:
            prev_state = decompress_state_dict(d / "model_quantized", stream,
                                               prev_state=prev_state)
        _, img = decode(frame_dirs[t], prev_state)
        if stats is not None:
            stats["frame_s"] = times
        return img, frame_dirs[t].name

    out = []
    prev_state = None
    for d in frame_dirs:
        prev_state, img = decode(d, prev_state)
        out.append(img)
    if stats is not None:
        stats["frame_s"] = times
    return np.stack(out), [d.name for d in frame_dirs]


@catch_error_decorator
def cli(argv=None) -> None:
    """encode (the default; a leading `encode` is optional), `pack <seq_dir>
    [out.iiv]` and `decode <seq_dir|file.iiv> [frame=t] [device=cpu]`, which
    writes each decoded frame as <name>.png beside the dir or file."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "decode":
        from implicit_image_tpu_torch.data import save_img

        if len(argv) < 2:
            raise SystemExit("usage: decode <seq_dir|file.iiv> [frame=t] [device=cpu]")
        seek, device = None, "cuda"
        for a in argv[2:]:
            if a.startswith("frame="):
                seek = int(a.split("=", 1)[1])
            elif a.startswith("device="):
                device = a.split("=", 1)[1]
        out_root = Path(argv[1])
        out_root = out_root.parent if out_root.is_file() else out_root
        stats: dict = {}
        t0 = time.perf_counter()
        if seek is not None:
            img, name = decode_sequence(argv[1], frame=seek, device=device)
            wall = time.perf_counter() - t0
            save_img(str(out_root / f"{name}.png"), img)
            print(f"decoded frame {seek} ({name}, {img.shape[0]}x{img.shape[1]}) via GOP seek "
                  f"in {wall:.2f}s")
            return
        frames, names = decode_sequence(argv[1], device=device, stats=stats)
        wall = time.perf_counter() - t0
        for f, n in zip(frames, names):
            save_img(str(out_root / f"{n}.png"), f)
        t, h, w = frames.shape[:3]
        steady = stats["frame_s"][1:]
        rate = f", steady {len(steady) / sum(steady):.1f} frames/s after the first" if steady \
            else ""
        print(f"decoded {t} frames ({h}x{w}) -> {out_root}/frame_*.png in {wall:.2f}s "
              f"({t / wall:.1f} frames/s incl. host entropy decode + chain walk{rate})")
        return
    if argv and argv[0] == "pack":
        from implicit_image_tpu_torch.coding.container_file import pack_sequence

        if len(argv) < 2:
            raise SystemExit("usage: pack <seq_dir> [out.iiv]")
        out = pack_sequence(argv[1], argv[2] if len(argv) > 2 else None)
        print(f"packed {argv[1]} -> {out} ({out.stat().st_size} bytes)")
        return
    if argv and argv[0] == "encode":
        argv = argv[1:]
    encode_sequence(argv)


if __name__ == "__main__":
    cli()
