"""ImageLocality: prefer nodes that already hold the pod's images.

Counterpart of ``kubernetes_tpu/ops/imagelocality.py``.  Reference
(plugins/imagelocality/image_locality.go): a node scores the summed sizes
of the pod's container images it already holds, each scaled by the image's
spread over the cluster (``size × numNodesWithImage/totalNodes``, :117
scaledImageScore, truncated to int64 per image), then clamped into
[23 MiB, 1000 MiB × numContainers] and mapped onto [0, MaxNodeScore]
(:84 calculatePriority).  Image names are normalized to a tagged form
(:128 normalizedImageName).

Node rows carry interned image-name slots (one per alias) with sizes; a pod
ships the ids of its containers' images, -1 for an image no node reports.
The score is computed in two steps, as the ``image_locality`` kernels
(kernels/csrc/image_locality.cu) compute it on the card: the spread
counts once per pass (``image_counts``) and the (K, N) raw score of a
whole batch (``image_scores``), which ``eval_chunk`` adds with the op's
weight; the functions below are their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import types as t
from ..framework.config import MAX_NODE_SCORE
from ..snapshot import _bucket
from .common import FeaturizeContext, OpDef, PassContext, feature_fill, register

MB = 1024 * 1024
MIN_THRESHOLD = 23 * MB
MAX_CONTAINER_THRESHOLD = 1000 * MB
# Elements of a block's (pods, N, IM) image match in image_scores.
IMAGE_ELEMS = 2**26


def normalized_image_name(name: str) -> str:
    """image_locality.go:128: append :latest when the reference has no tag."""
    if name.rfind(":") <= name.rfind("/"):
        name = name + ":latest"
    return name


def featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    refs = [
        normalized_image_name(img)
        for c in list(pod.spec.init_containers) + list(pod.spec.containers)
        for img in c.images
    ]
    # An image no node reports can never be on a node: -1 (scores 0).
    ids = [fctx.interns.images.get(r) for r in refs]
    arr = np.full(_bucket(max(len(ids), 1), 1), -1, np.int32)
    arr[: len(ids)] = ids
    n_containers = len(pod.spec.init_containers) + len(pod.spec.containers)
    return {"il_image_ids": arr, "il_ncontainers": np.int64(max(n_containers, 1))}


def finish(sum_scores: torch.Tensor, ncontainers: torch.Tensor) -> torch.Tensor:
    """calculatePriority: the clamp into [MIN_THRESHOLD, 1000 MiB ×
    ncontainers] and the floor-divided map onto [0, MAX_NODE_SCORE];
    ``sum_scores`` (C, N) i64, ``ncontainers`` (C,) i64."""
    max_threshold = (MAX_CONTAINER_THRESHOLD * ncontainers)[:, None]
    clamped = torch.minimum(sum_scores.clamp(min=MIN_THRESHOLD), max_threshold)
    denom = (max_threshold - MIN_THRESHOLD).clamp(min=1)
    return torch.div(MAX_NODE_SCORE * (clamped - MIN_THRESHOLD), denom, rounding_mode="floor")


def image_counts(state, vocab: int):
    """(vocab + 1,) i32: entry v is the number of valid nodes whose image
    slots hold id v (once per node, however many of its slots do; ids
    outside [0, vocab) are not counted), the last entry the number of valid
    nodes — ImageLocality's spread numerators and denominator
    (kubernetes_tpu/ops/imagelocality.py:62-65), once per pass."""
    ids = state.image_ids.to(torch.int64).sort(dim=1).values  # (N, IM)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = ids[:, 1:] != ids[:, :-1]
    keep = first & (ids >= 0) & (ids < vocab) & state.valid[:, None]
    counts = torch.bincount(ids[keep], minlength=vocab)[:vocab]
    total = state.valid.sum().reshape(1)
    return torch.cat([counts, total]).to(torch.int32)


def image_scores(state, pf: dict, counts, pin=None):
    """(K, N) u8: ImageLocality's raw score (kubernetes_tpu/ops/imagelocality.py:53) of every
    pod of a batch on every node, from ``counts`` (image_counts); 0 on the
    padding lanes (valid False).  Images and validity do not change within
    a pass, so one plane serves every chunk.  With ``pin`` ((K,) i32 rows)
    it is (K, 1), each pod on its pinned node alone, as the pinned pass
    evaluates it: the spread over that one row, so 1 where the row is valid
    and holds the image (``counts`` unused; pins clamped into [0, N))."""
    ids = pf["il_image_ids"].to(torch.int64)  # (K, CI)
    k, ci = ids.shape
    ncont = pf["il_ncontainers"].to(torch.int64)
    img, sizes = state.image_ids.to(torch.int64), state.image_sizes
    if pin is not None:
        row = pin.to(torch.int64).clamp(0, img.shape[0] - 1)
        own_ids, own_sizes = img[row], sizes[row]  # (K, IM)
        total = torch.zeros((k, 1), dtype=torch.int64, device=ids.device)
        for q in range(ci):
            want = ids[:, q]
            hit = (own_ids == want[:, None]) & (want >= 0)[:, None]
            size = torch.where(hit, own_sizes, 0).sum(dim=1)
            spread = (hit.any(dim=1) & state.valid[row]).to(torch.float64)
            total[:, 0] += (size.to(torch.float64) * spread).to(torch.int64)
        out = finish(total, ncont)
    else:
        vocab = counts.shape[0] - 1
        known = (ids >= 0) & (ids < vocab)
        cnt = torch.where(known, counts[ids.clamp(0, max(vocab - 1, 0))], 0)
        spread = cnt.to(torch.float64) / counts[-1].clamp(min=1).to(torch.float64)  # (K, CI)
        n, im = img.shape
        block = max(1, IMAGE_ELEMS // max(n * im, 1))
        out = torch.empty((k, n), dtype=torch.int64, device=ids.device)
        for lo in range(0, k, block):
            hi = min(lo + block, k)
            total = torch.zeros((hi - lo, n), dtype=torch.int64, device=ids.device)
            for q in range(ci):
                want = ids[lo:hi, q]
                hit = (img[None] == want[:, None, None]) & (want >= 0)[:, None, None]
                size = torch.where(hit, sizes[None], 0).sum(dim=2)  # (B, N)
                total += (size.to(torch.float64) * spread[lo:hi, q, None]).to(torch.int64)
            out[lo:hi] = finish(total, ncont[lo:hi])
    return torch.where(pf["valid"][:, None], out, 0).to(torch.uint8)


def score_fn(state, pf, ctx: PassContext, feasible):
    """(C, N) i64 in [0, MAX_NODE_SCORE]: the image_scores plane of the
    chunk over counts of every id it or the state holds."""
    ids = pf["il_image_ids"]
    vocab = int(max(int(state.image_ids.max()), int(ids.max()))) + 1
    valid = torch.ones(ids.shape[0], dtype=torch.bool, device=ids.device)
    return image_scores(state, dict(pf, valid=valid), image_counts(state, vocab)).to(torch.int64)


def is_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    # The score is 0 on every node when the pod names no image or no node
    # reports any (the clamp maps an empty sum to 0).
    if len(fctx.interns.images) == 0:
        return False
    return any(c.images for c in list(pod.spec.init_containers) + list(pod.spec.containers))


feature_fill("il_image_ids", -1)
feature_fill("il_ncontainers", 1)
register(OpDef(name="ImageLocality", featurize=featurize, score=score_fn, is_active=is_active))
