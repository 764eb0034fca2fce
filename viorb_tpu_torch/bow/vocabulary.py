"""Binary bag-of-words vocabulary: a k-branch tree over 256-bit descriptors
(port of viorb_tpu/bow/vocabulary.py; DBoW2's TemplatedVocabulary<FORB>
in the reference ORB-SLAM: transform, L1 scoring, save/load).

The arrays stay numpy, as in the reference, so both packages load each
other's files. Three descents compute the same words:
  * `transform`: the host numpy descent, vectorized over the descriptors
    (relocalization's query, as in the reference);
  * `transform_device` on a CUDA tensor: the hand-written kernel K8
    (`csrc/bow_descend.cu` through `descend_cuda.py`), the per-keyframe
    path of place recognition;
  * `transform_device` on a CPU tensor: `_descend_torch`, K8's plain twin,
    the reference's +-1 f32 matmul descent, exactly as the reference does
    it (f32 sums of +-1 are exact, so ties break as there).
`train_vocabulary` is the reference's host k-medians, numpy for numpy:
the same seed gives the same arrays.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch


class BinaryVocabulary(NamedTuple):
    """A complete k-ary tree in array form.

    children: (n_nodes, k) int32 node ids (-1 = none);
    centers_pm1: (n_nodes, 256) f32 in {-1,+1} (the root's row unused);
    is_leaf: (n_nodes,) bool; word_id: (n_nodes,) int32 (-1 off the leaves);
    idf: (n_words,) f32 weights.
    """

    children: np.ndarray
    centers_pm1: np.ndarray
    is_leaf: np.ndarray
    word_id: np.ndarray
    idf: np.ndarray

    @property
    def k(self) -> int:
        return self.children.shape[1]

    @property
    def n_words(self) -> int:
        return len(self.idf)

    def save(self, path: str):
        np.savez_compressed(
            path,
            children=self.children,
            centers=(self.centers_pm1 > 0).astype(np.uint8),
            is_leaf=self.is_leaf,
            word_id=self.word_id,
            idf=self.idf,
        )

    @staticmethod
    def load(path: str) -> "BinaryVocabulary":
        d = np.load(path)
        return BinaryVocabulary(
            children=d["children"],
            centers_pm1=d["centers"].astype(np.float32) * 2 - 1,
            is_leaf=d["is_leaf"],
            word_id=d["word_id"],
            idf=d["idf"],
        )

    # -- transform ---------------------------------------------------------

    def transform(self, desc01: np.ndarray, valid: np.ndarray | None = None):
        """(N,256) {0,1} descriptors -> (word ids (N,), bow {word: weight}),
        on the host (numpy, vectorized over N)."""
        d = desc01.astype(np.float32) * 2 - 1
        n = len(d)
        node = np.zeros(n, np.int64)
        if valid is None:
            valid = np.ones(n, bool)
        active = valid.copy()
        for _ in range(64):  # depth bound
            leaf = self.is_leaf[node]
            work = active & ~leaf
            if not work.any():
                break
            ch = self.children[node[work]]  # (M,k)
            cent = self.centers_pm1[np.maximum(ch, 0)]  # (M,k,256)
            sim = np.einsum("mkd,md->mk", cent, d[work])
            sim[ch < 0] = -1e9
            best = np.argmax(sim, axis=1)
            node[work] = ch[np.arange(len(best)), best]
        words = np.where(valid, self.word_id[node], -1)
        bow: Dict[int, float] = {}
        for w in words[words >= 0]:
            bow[int(w)] = bow.get(int(w), 0.0) + float(self.idf[w])
        s = sum(bow.values())  # L1 normalize
        if s > 0:
            bow = {k: v / s for k, v in bow.items()}
        return words, bow

    def device_arrays(self, device) -> "DeviceVocabulary":
        """The tree on `device`, uploaded once per (vocabulary, device)."""
        device = torch.device(device)
        key = (id(self), str(device))
        ent = _device_cache.get(key)
        if ent is None or ent[0] is not self:
            ent = (self, DeviceVocabulary.upload(self, device))
            _device_cache[key] = ent
        return ent[1]

    def transform_device(self, desc01: torch.Tensor, valid: torch.Tensor):
        """Batched descent of a whole keyframe on the device: (N,256) uint8
        {0,1} and (N,) bool tensors -> (word ids (N,) int32 tensor, bow
        {word: weight} on the host). On a CUDA tensor it is K8, on a CPU
        tensor its plain twin. One pull of the words and the weights."""
        words, weights = descend(self.device_arrays(desc01.device), desc01, valid)
        words_np = words.cpu().numpy()
        weights_np = weights.cpu().numpy()
        bow: Dict[int, float] = {}
        for w in np.unique(words_np[words_np >= 0]):
            bow[int(w)] = float(weights_np[w])
        return words, bow

    @staticmethod
    def score(bow_a: Dict[int, float], bow_b: Dict[int, float]) -> float:
        """L1 score in [0,1] (DBoW2's L1Scoring): 1 - |va - vb|_1 / 2 over
        the union = the sum over common words of (|a|+|b|-|a-b|)/2."""
        s = 0.0
        for w, va in bow_a.items():
            vb = bow_b.get(w)
            if vb is not None:
                s += abs(va) + abs(vb) - abs(va - vb)
        return 0.5 * s


class DeviceVocabulary(NamedTuple):
    """A vocabulary's tree on one device: the kernel's packed centers
    (n_nodes, 8) int32 words of 32 bits (bit b of a descriptor is bit b%32 of
    word b/32) and the twin's (n_nodes, 256) +-1 f32 centers (on the CPU
    only), children int32, is_leaf uint8, word_id int32, idf f32."""

    centers_packed: torch.Tensor
    centers_pm1: torch.Tensor | None
    children: torch.Tensor
    is_leaf: torch.Tensor
    word_id: torch.Tensor
    idf: torch.Tensor

    @staticmethod
    def upload(vocab: BinaryVocabulary, device: torch.device) -> "DeviceVocabulary":
        bits = np.packbits((vocab.centers_pm1 > 0).astype(np.uint8), axis=1, bitorder="little")
        packed = np.ascontiguousarray(bits).view("<u4").view(np.int32)  # (n_nodes, 8)

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        return DeviceVocabulary(
            centers_packed=up(packed, np.int32),
            centers_pm1=up(vocab.centers_pm1, np.float32) if device.type == "cpu" else None,
            children=up(vocab.children, np.int32),
            is_leaf=up(vocab.is_leaf, np.uint8),
            word_id=up(vocab.word_id, np.int32),
            idf=up(vocab.idf, np.float32),
        )


_device_cache: Dict[tuple, tuple] = {}

MAX_DEPTH = 8  # the descent's level bound: vocabulary trees are shallow


def descend(dv: DeviceVocabulary, desc01: torch.Tensor, valid: torch.Tensor):
    """(words (N,) int32, weights (n_words,) f32): the leaf word of every
    descriptor (-1 on invalid rows) and the L1-normalized tf-idf histogram.
    A CUDA tensor goes to K8, a CPU tensor to the plain twin."""
    if desc01.is_cuda:
        from viorb_tpu_torch.bow.descend_cuda import bow_descend_cuda

        return bow_descend_cuda(dv, desc01, valid)
    if dv.centers_pm1 is None:
        raise ValueError("the plain BoW descent needs the vocabulary on the CPU")
    return _descend_torch(dv, desc01.to(torch.float32) * 2 - 1, valid)


def _descend_torch(dv: DeviceVocabulary, desc_pm1: torch.Tensor, valid: torch.Tensor):
    """K8's plain twin, the reference's `_descend_device`: at each level the
    children's +-1 centers dotted with the +-1 descriptors, argmax (ties to
    the first slot), leaves stay; then a scatter-add of idf weights,
    normalized by max(sum, 1e-12)."""
    n = desc_pm1.shape[0]
    children = dv.children.to(torch.int64)
    node = torch.zeros(n, dtype=torch.int64, device=desc_pm1.device)
    leaf = dv.is_leaf.bool()
    for _ in range(MAX_DEPTH):
        ch = children[node]  # (N,k)
        cent = dv.centers_pm1[ch.clamp(min=0)]  # (N,k,256)
        sim = torch.einsum("nkd,nd->nk", cent, desc_pm1)
        sim = torch.where(ch >= 0, sim, torch.full_like(sim, -1e9))
        best = torch.gather(ch, 1, torch.argmax(sim, dim=1, keepdim=True))[:, 0]
        node = torch.where(leaf[node], node, best)
    words = torch.where(valid, dv.word_id[node], -1).to(torch.int32)
    n_words = dv.idf.shape[0]
    ok = words >= 0
    hist = torch.zeros(n_words, dtype=torch.float32, device=desc_pm1.device)
    hist.index_add_(0, words[ok].to(torch.int64), dv.idf[words[ok].to(torch.int64)])
    return words, hist / hist.sum().clamp(min=1e-12)


def train_vocabulary(
    descriptors01: np.ndarray,  # (N,256) {0,1}
    k: int = 8,
    depth: int = 4,
    seed: int = 0,
    kmeans_iters: int = 8,
) -> BinaryVocabulary:
    """Hierarchical k-medians with Hamming distance (DBoW2's create()), on
    the host; the reference's function, numpy for numpy."""
    rng = np.random.default_rng(seed)
    d = descriptors01.astype(np.uint8)

    children_rows: List[np.ndarray] = []
    centers_rows: List[np.ndarray] = [np.zeros(256, np.float32)]  # the root's center is unused
    children_rows.append(np.full(k, -1, np.int32))  # the root, filled later
    is_leaf: List[bool] = [False]
    word_of: List[int] = [-1]
    n_words = 0
    word_counts: List[int] = []

    def kmedians(data: np.ndarray):
        m = len(data)
        kk = min(k, m)
        centers = data[rng.choice(m, kk, replace=False)].astype(np.float32)
        for _ in range(kmeans_iters):
            # Hamming distances through the +-1 dot
            dpm = data.astype(np.float32) * 2 - 1
            cpm = centers * 2 - 1
            sim = dpm @ cpm.T
            assign = np.argmax(sim, axis=1)
            for c in range(kk):
                sel = data[assign == c]
                if len(sel) == 0:
                    centers[c] = data[rng.integers(m)]
                else:
                    centers[c] = (sel.mean(0) > 0.5).astype(np.float32)
        return centers.astype(np.uint8), assign

    def build(node_id: int, data: np.ndarray, level: int):
        nonlocal n_words
        if level == depth or len(data) <= k:
            is_leaf[node_id] = True
            word_of[node_id] = n_words
            word_counts.append(len(data))
            n_words += 1
            return
        centers, assign = kmedians(data)
        ch_ids = []
        for c in range(len(centers)):
            cid = len(children_rows)
            children_rows.append(np.full(k, -1, np.int32))
            centers_rows.append(centers[c].astype(np.float32))
            is_leaf.append(False)
            word_of.append(-1)
            ch_ids.append(cid)
        row = np.full(k, -1, np.int32)
        row[: len(ch_ids)] = ch_ids
        children_rows[node_id] = row
        for c, cid in enumerate(ch_ids):
            sel = data[assign == c]
            if len(sel) == 0:
                is_leaf[cid] = True
                word_of[cid] = n_words
                word_counts.append(0)
                n_words += 1
            else:
                build(cid, sel, level + 1)

    build(0, d, 0)
    total = max(len(d), 1)
    idf = np.array([np.log(total / max(c, 1)) for c in word_counts], np.float32)
    return BinaryVocabulary(
        children=np.stack(children_rows),
        centers_pm1=np.stack(centers_rows) * 2 - 1,
        is_leaf=np.array(is_leaf),
        word_id=np.array(word_of, np.int32),
        idf=idf,
    )
