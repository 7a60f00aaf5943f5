"""Bjøntegaard delta (BD-rate / BD-PSNR) between two R-D curves
(counterpart of implicit_image_tpu/visualize/bd_rate.py; the same rules,
reading the run store through the port's own visualize/runs.py).

The standard codec-comparison statistic (Bjøntegaard, VCEG-M33 2001):
fit each curve with a cubic polynomial — PSNR as a function of log-rate
(BD-PSNR) or log-rate as a function of PSNR (BD-rate) — and integrate
the gap over the overlapping interval. BD-rate answers "how many percent
fewer bits does the test codec need for the same quality, averaged over
the curve"; BD-PSNR is the same gap on the quality axis.

Curves come from the local run store (`collect_runs`, summary keys
'Compressed Bytes' + 'Decoded PSNR'):

    python -m implicit_image_tpu_torch.visualize.bd_rate \
        outputs/synthetic/lwd_abs outputs/synthetic/lwd_delta

prints the BD-rate and BD-PSNR of the second (test) tree vs the first
(anchor). Negative BD-rate = the test curve needs fewer bytes at equal
quality.
"""
from __future__ import annotations

import json
import sys
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from implicit_image_tpu_torch.visualize.runs import collect_runs

__all__ = ["bd_rate", "bd_psnr", "curve_from_runs"]

Point = Tuple[float, float]  # (rate in bytes, PSNR in dB)


def _prepare(points: Iterable[Point]) -> Tuple[np.ndarray, np.ndarray]:
    """(log10-rate, psnr) arrays sorted by rate, validated.

    Real run-store ladders carry seed noise (a slightly non-monotone PSNR
    rung) and occasional duplicate byte counts (the same config re-run);
    the Bjøntegaard polynomial fit handles noise, so only hard errors are
    rejected — exact-duplicate rates are merged by averaging their PSNRs.
    """
    pts = sorted((float(r), float(p)) for r, p in points)
    if any(r <= 0 for r, _ in pts):
        raise ValueError("rates must be positive (bytes)")
    merged: list = []
    for r, p in pts:
        if merged and merged[-1][0] == r:
            prev_r, prev_p, n = merged[-1]
            merged[-1] = (r, (prev_p * n + p) / (n + 1), n + 1)
        else:
            merged.append((r, p, 1))
    if len(merged) < 2:
        raise ValueError(
            f"a BD curve needs >=2 distinct-rate points, got {len(merged)}"
        )
    rates = np.array([r for r, _, _ in merged])
    psnrs = np.array([p for _, p, _ in merged])
    return np.log10(rates), psnrs


def _poly_average(
    x1: np.ndarray, y1: np.ndarray, x2: np.ndarray, y2: np.ndarray
) -> float:
    """Mean (curve2 - curve1) over the overlapping x interval, each curve
    fitted with a degree-min(3, n-1) polynomial (the Bjøntegaard cubic
    when 4+ points are available)."""
    lo = max(x1.min(), x2.min())
    hi = min(x1.max(), x2.max())
    if hi <= lo:
        raise ValueError(
            "R-D curves do not overlap on the integration axis "
            f"([{x1.min():.3f}, {x1.max():.3f}] vs "
            f"[{x2.min():.3f}, {x2.max():.3f}]) — BD metrics are undefined"
        )
    total = 0.0
    for x, y, sign in ((x1, y1, -1.0), (x2, y2, 1.0)):
        deg = min(3, len(x) - 1)
        poly = np.polynomial.Polynomial.fit(x, y, deg)
        integ = poly.integ()
        total += sign * (integ(hi) - integ(lo))
    return total / (hi - lo)


def bd_psnr(anchor: Iterable[Point], test: Iterable[Point]) -> float:
    """Average PSNR gain (dB) of `test` over `anchor` at equal rate.

    Positive = the test curve sits above the anchor.
    """
    xa, ya = _prepare(anchor)
    xt, yt = _prepare(test)
    return float(_poly_average(xa, ya, xt, yt))


def bd_rate(anchor: Iterable[Point], test: Iterable[Point]) -> float:
    """Average rate change (percent) of `test` vs `anchor` at equal
    quality. Negative = the test curve needs fewer bytes (better).
    """
    xa, ya = _prepare(anchor)
    xt, yt = _prepare(test)
    # axes swapped: integrate log-rate as a function of PSNR
    avg_log = _poly_average(ya, xa, yt, xt)
    return float((10.0 ** avg_log - 1.0) * 100.0)


def curve_from_runs(
    root, metric: str = "Decoded PSNR"
) -> List[Point]:
    """(bytes, PSNR) ladder from every run-store dir under `root`."""
    points = [
        (float(run["Compressed Bytes"]), float(run[metric]))
        for run in collect_runs(root, require=["Compressed Bytes", metric])
    ]
    if not points:
        raise FileNotFoundError(
            f"no runs with 'Compressed Bytes' + {metric!r} under {root}"
        )
    return points


def main(argv: Sequence[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    metric = "Decoded PSNR"
    if "--metric" in argv:
        i = argv.index("--metric")
        if i + 1 >= len(argv):
            raise SystemExit("--metric needs a value, e.g. --metric 'PSNR'")
        metric = argv[i + 1]
        del argv[i : i + 2]
    if len(argv) != 2:
        raise SystemExit(
            "usage: python -m implicit_image_tpu_torch.visualize.bd_rate "
            "<anchor_runs_root> <test_runs_root> [--metric 'Decoded PSNR']"
        )
    anchor = curve_from_runs(argv[0], metric)
    test = curve_from_runs(argv[1], metric)
    out = {
        "anchor": argv[0],
        "test": argv[1],
        "metric": metric,
        "anchor_points": len(anchor),
        "test_points": len(test),
        "bd_rate_pct": round(bd_rate(anchor, test), 3),
        "bd_psnr_db": round(bd_psnr(anchor, test), 4),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
