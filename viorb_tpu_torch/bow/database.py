"""Keyframe database: an inverted file over vocabulary words (port of
viorb_tpu/bow/database.py; the reference ORB-SLAM's KeyFrameDatabase:
shared-word counting, a min-score gate, DetectLoopCandidates). Host
dictionaries, as in the reference: the same queries return the same lists
in the same order."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Set, Tuple

from viorb_tpu_torch.bow.vocabulary import BinaryVocabulary


class KeyframeDatabase:
    def __init__(self, vocab: BinaryVocabulary):
        self.vocab = vocab
        self.inverted: Dict[int, Set[int]] = defaultdict(set)
        self.bows: Dict[int, Dict[int, float]] = {}

    def add(self, kf_id: int, bow: Dict[int, float]):
        self.bows[kf_id] = bow
        for w in bow:
            self.inverted[w].add(kf_id)

    def remove(self, kf_id: int):
        bow = self.bows.pop(kf_id, None)
        if bow:
            for w in bow:
                self.inverted[w].discard(kf_id)

    def query(
        self,
        bow: Dict[int, float],
        exclude: Set[int] = frozenset(),
        min_score: float = 0.0,
        max_results: int = 10,
    ) -> List[Tuple[int, float]]:
        """Keyframes sharing words with `bow`, at least 0.8x the most shared
        words (the reference's gate), scored L1, at or above min_score, best
        first."""
        shared: Dict[int, int] = defaultdict(int)
        for w in bow:
            for kf in self.inverted[w]:
                if kf not in exclude:
                    shared[kf] += 1
        if not shared:
            return []
        min_common = max(int(0.8 * max(shared.values())), 1)
        out = []
        for kf, c in shared.items():
            if c < min_common:
                continue
            s = BinaryVocabulary.score(bow, self.bows[kf])
            if s >= min_score:
                out.append((kf, s))
        out.sort(key=lambda x: -x[1])
        return out[:max_results]

    def detect_loop_candidates(
        self,
        kf_id: int,
        bow: Dict[int, float],
        covisible: Set[int],
        min_score: float,
        max_results: int = 10,
    ) -> List[Tuple[int, float]]:
        """Loop candidates: the query keyframe and its covisible keyframes
        excluded; min_score is typically the lowest BoW score among the
        covisible neighbours (reference LoopClosing::DetectLoop)."""
        return self.query(bow, exclude=covisible | {kf_id}, min_score=min_score, max_results=max_results)
