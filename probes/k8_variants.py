"""K8 on the card in one call: the one-launch cluster kernel
(viorb_tpu_torch/csrc/bow_descend.cu: its shared and global paths, clusters
of 8 and 16 CTAs) held to its plain twin, and timed beside the earlier
two-launch kernel (probes/bow_descend_two_launch.cu: a memset and two
launches), the plain twin and an empty launch; device operations a call by
the profiler.

    python3 probes/k8_variants.py

Descriptors are random bits (seeded), trees the stock vocabulary and one
trained on random bits (k=8, depth 3)."""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from viorb_tpu_torch import cuda_build  # noqa: E402
from viorb_tpu_torch.bow import default_vocabulary, descend_cuda, train_vocabulary  # noqa: E402
from viorb_tpu_torch.bow.vocabulary import _descend_torch  # noqa: E402
from viorb_tpu_torch.features import fast_cuda  # noqa: E402

print(cs._card())
cuda_build.load_libraries([fast_cuda.LIB_NAME, descend_cuda.LIB_NAME])
for line in cuda_build.build_info(descend_cuda.LIB_NAME)[1].splitlines():
    if "registers" in line or "spill" in line:
        print("  ptxas:", line.strip())
old_path = os.path.join(cuda_build.BUILD_DIR, "libbow_descend_two_launch.so")
subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", old_path,
                os.path.join(ROOT, "probes", "bow_descend_two_launch.cu")], check=True)
old = ctypes.CDLL(old_path)
P, I = ctypes.c_void_p, ctypes.c_int
old.viorb_bow_descend.argtypes = [P, P, I, P, P, P, P, I, I, P, I, P, P, P, P]
old.viorb_bow_descend.restype = I
empty = ctypes.CDLL(os.path.join(cuda_build.BUILD_DIR, "libfast_score.so")).viorb_empty_launch
empty.argtypes, empty.restype = [P], I


def old_call(dv, desc, valid):
    """The earlier wrapper: a cast of the flags, a zeroed counts tensor, two launches."""
    n, n_words = desc.shape[0], dv.idf.shape[0]
    valid_u8 = valid.to(torch.uint8).contiguous()
    words = torch.empty(n, dtype=torch.int32, device=desc.device)
    counts = torch.zeros(n_words, dtype=torch.int32, device=desc.device)
    weights = torch.empty(n_words, dtype=torch.float32, device=desc.device)
    rc = old.viorb_bow_descend(desc.data_ptr(), valid_u8.data_ptr(), n, dv.centers_packed.data_ptr(),
                               dv.children.data_ptr(), dv.is_leaf.data_ptr(), dv.word_id.data_ptr(),
                               dv.children.shape[0], dv.children.shape[1], dv.idf.data_ptr(), n_words,
                               words.data_ptr(), counts.data_ptr(), weights.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return words, weights


def new_call(dv, desc, valid, path, cluster):
    descend_cuda.CLUSTER_CTAS = cluster
    return descend_cuda.bow_descend_cuda(dv, desc, valid, path=path)


dev = torch.device("cuda")
rng = np.random.default_rng(0)
vocabs = {"stock": default_vocabulary(),
          "trained k=8 depth 3": train_vocabulary(rng.integers(0, 2, (3000, 256)).astype(np.uint8), k=8, depth=3)}
print("shared path holds", descend_cuda.shared_hist_max_words(dev), "words")
worst = 0.0
for vname, vocab in vocabs.items():
    dv = vocab.device_arrays(dev)
    twin = dv._replace(centers_pm1=torch.from_numpy(vocab.centers_pm1).to(dev))
    for n in (0, 1, 1000, 5000):
        desc = torch.from_numpy(rng.integers(0, 2, (n, 256)).astype(np.uint8)).to(dev)
        for vlabel, valid in (("90 % valid", torch.from_numpy(rng.random(n) > 0.1).to(dev)),
                              ("all invalid", torch.zeros(n, dtype=torch.bool, device=dev))):
            pw, pv = _descend_torch(twin, desc.float() * 2 - 1, valid)
            for path in ("shared", "global"):
                for cluster in (8, 16):
                    w1, v1 = new_call(dv, desc, valid, path, cluster)
                    w2, v2 = new_call(dv, desc, valid, path, cluster)
                    assert torch.equal(w1, w2) and torch.equal(v1, v2), (vname, n, vlabel, path, cluster, "repeat")
                    assert torch.equal(w1, pw), (vname, n, vlabel, path, cluster, "words")
                    err = (v1 - pv).abs()
                    rel = float((err / pv.clamp(min=1e-30)).max()) if bool((pv > 0).any()) else 0.0
                    assert bool((err[pv == 0] == 0).all()) and rel <= 1e-6, (vname, n, vlabel, path, cluster, rel)
                    worst = max(worst, rel)
        print(f"{vname}, n={n}: both paths, clusters 8 and 16: words torch.equal, weights within 1e-6, repeats equal")
print(f"weights: worst relative error {worst:.2e}")

dv = vocabs["stock"].device_arrays(dev)
twin = dv._replace(centers_pm1=torch.from_numpy(vocabs["stock"].centers_pm1).to(dev))
stream = torch.cuda.current_stream().cuda_stream
for n in (1000, 5000):
    desc = torch.from_numpy(rng.integers(0, 2, (n, 256)).astype(np.uint8)).to(dev)
    valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    cands = {"two-launch kernel (memset + 2 launches)": lambda: old_call(dv, desc, valid)}
    for path in ("shared", "global"):
        for cluster in (8, 16):
            cands[f"one launch, {path}, cluster {cluster}"] = (lambda p=path, c=cluster: new_call(dv, desc, valid, p, c))
    cands["plain twin"] = lambda: _descend_torch(twin, desc.float() * 2 - 1, valid)
    for _round in range(2):  # in turns: the card's clocks drift within a call
        for name, fn in cands.items():
            ms = cs._event_ms(fn, reps=20 if name == "plain twin" else 300, device_only=True)
            ops = cs._kernels_per_call(fn) if _round == 0 else None
            print(f"n={n} {name}: device time {ms * 1e3:.2f} us" + (f", {ops} device operations a call" if ops is not None else ""))
    descend_cuda.CLUSTER_CTAS = 16
one = torch.zeros((1, 256), dtype=torch.uint8, device=dev)
one_valid = torch.ones(1, dtype=torch.bool, device=dev)
for cluster in (8, 16):
    ms = cs._event_ms(lambda: new_call(dv, one, one_valid, "shared", cluster), reps=300, device_only=True)
    print(f"n=1 one launch, shared, cluster {cluster}: device time {ms * 1e3:.2f} us")
descend_cuda.CLUSTER_CTAS = 16
print(f"empty launch: {cs._event_ms(lambda: empty(stream), reps=1000, device_only=True) * 1e3:.2f} us")
