"""Binary bag-of-words place recognition (port of viorb_tpu/bow: DBoW2's
k-branch vocabulary tree with tf-idf weights, and the keyframe database's
inverted file)."""

import os

from viorb_tpu_torch.bow.database import KeyframeDatabase
from viorb_tpu_torch.bow.vocabulary import BinaryVocabulary, train_vocabulary

ASSET_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "vocab.npz")


def default_vocabulary() -> BinaryVocabulary:
    """The shipped general-purpose vocabulary: the port's own copy of the
    JAX package's assets/vocab.npz (byte for byte; trained there by
    `bow.build_asset` on held-out synthetic worlds: 1111 nodes, k = 10,
    1000 words, depth 3)."""
    return BinaryVocabulary.load(ASSET_PATH)
