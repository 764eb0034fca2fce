"""Plot VI-initialization convergence dumps (port of
viorb_tpu/eval/plot_init.py).

Counterpart of the reference's pyplotscripts/plotinit.py (which plots the
tmp/*.txt series written by src/LocalMapping.cc:527-547): scale estimate,
gravity vector components, gyro/accel biases, condition number over time.
A workstation tool, off the device path: the plot needs matplotlib, which
`main` imports and which the SLAM host need not have; `load_series` needs
numpy only.

Usage:
  python -m viorb_tpu_torch.eval.plot_init [--dir tmp] [--out init_convergence.png]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

PANELS = [
    ("scale.txt", "scale estimate", ["s"]),
    ("gw.txt", "gravity (world)", ["gx", "gy", "gz"]),
    ("biasg.txt", "gyro bias", ["bgx", "bgy", "bgz"]),
    ("biasa.txt", "accel bias", ["bax", "bay", "baz"]),
    ("condnum.txt", "condition number", ["cond"]),
]


def load_series(d: str, name: str):
    """The rows of `d/name` as an (N, cols) array; None without the file."""
    path = os.path.join(d, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rows = [[float(x) for x in ln.split()] for ln in f if ln.strip()]
    return np.array(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description="plot VI init convergence")
    ap.add_argument("--dir", default="tmp")
    ap.add_argument("--out", default="init_convergence.png")
    args = ap.parse_args(argv)

    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit("plot_init needs matplotlib to draw its plot; load_series reads the series without it") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(PANELS), 1, figsize=(8, 3 * len(PANELS)))
    for ax, (name, title, labels) in zip(axes, PANELS):
        data = load_series(args.dir, name)
        ax.set_title(title)
        if data is None or len(data) == 0:
            ax.text(0.5, 0.5, f"{name} missing", ha="center")
            continue
        for j, lab in enumerate(labels):
            ax.plot(data[:, 0], data[:, 1 + j], label=lab, marker="o", ms=3)
        ax.legend()
        ax.set_xlabel("t [s]")
        if name == "condnum.txt":
            ax.set_yscale("log")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
