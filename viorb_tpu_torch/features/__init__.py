"""Feature engine: ORB pyramid extraction and Hamming matching (port of
viorb_tpu.features)."""

from viorb_tpu_torch.features.extractor import FrameFeatures, OrbExtractor
from viorb_tpu_torch.features.matching import (
    BIG,
    TH_LOW,
    MatchResult,
    hamming_matrix,
    match_with_mask,
    valid_gate,
)
