"""Build a standing vocabulary artifact (port of
viorb_tpu/bow/build_asset.py).

The reference ships a general pre-trained ORB vocabulary and a binary
loader (reference: Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:241-259,
tools/bin_vocabulary.cc:6-30) so place recognition works on scenes never
seen at training time. This is its counterpart: train the k-medians tree
on descriptors harvested from several HELD-OUT synthetic worlds (seeds
disjoint from every test/bench seed) and save it. The port's shipped
`assets/vocab.npz` is the JAX package's file, copied byte for byte; this
module writes to the path it is given and replaces that asset only when
asked to (`--overwrite-asset`).

Usage:
  python -m viorb_tpu_torch.bow.build_asset OUT.npz [--device cpu]
  python -m viorb_tpu_torch.bow.build_asset --overwrite-asset
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from viorb_tpu_torch.bow import ASSET_PATH

# held-out worlds: test/bench clips use seeds 0-9
TRAIN_SEEDS = (101, 202, 303, 404)


def build(out_path: str, frames_per_world: int = 8, device=None) -> str:
    """Render `frames_per_world` frames of each held-out world on `device`
    (None: the card), extract 800 ORB features a frame there, train
    k = 10, depth 3 (seed 7) on the host and save to `out_path`."""
    from viorb_tpu_torch.bow.vocabulary import train_vocabulary
    from viorb_tpu_torch.features import OrbExtractor
    from viorb_tpu_torch.io.synthetic import make_sequence

    extractor = OrbExtractor(n_features=800)
    descs = []
    for seed in TRAIN_SEEDS:
        seq = make_sequence(n_frames=frames_per_world, seed=seed, dt=0.15, device=device)
        for img in seq.images:
            f = extractor.extract(img, device=img.device)
            descs.append(f.desc01[f.valid].cpu().numpy())
    vocab = train_vocabulary(np.concatenate(descs), k=10, depth=3, seed=7)
    if os.path.dirname(out_path):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    vocab.save(out_path)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description="train the BoW vocabulary on held-out synthetic worlds")
    ap.add_argument("out", nargs="?", help="the .npz to write")
    ap.add_argument("--overwrite-asset", action="store_true",
                    help=f"write the shipped vocabulary ({ASSET_PATH}) instead of OUT")
    ap.add_argument("--device", default=None, help="torch device to render and extract on (default: the card)")
    args = ap.parse_args(argv)
    if bool(args.out) == args.overwrite_asset:
        ap.error("give either OUT or --overwrite-asset")
    path = build(ASSET_PATH if args.overwrite_asset else args.out, device=args.device)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
