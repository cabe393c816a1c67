"""Deterministic synthetic data streams: the port's own copy of
``repro.data.synthetic`` (numpy only), so its batches are bit for bit the
reference's.  CIFAR10/BSD300/MNIST are unavailable offline; these
generators match shapes/statistics and are *learnable*, so the paper's
relative claims — overflow collapse, sparsity growth, Pareto dominance —
reproduce.

Every stream is **stateless**: batch ``i`` is a pure function of ``(seed, i)``,
so checkpoint/resume and elastic re-sharding need no iterator state — the
trainer just records the step index (fault-tolerance substrate, Sec. 4).
Shard-awareness: ``shard(batch, n, idx)`` slices the global batch for a data
shard; generation itself is identical on every host (deterministic), so no
host ever needs another host's stream.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

__all__ = ["TokenStream", "BinaryMnistStream", "ImageClassStream", "SuperResStream", "shard"]


def _rng(seed: int, step: int) -> np.random.Generator:
    # step -1 is the conventional "fixed structure" stream (templates/protos)
    return np.random.default_rng(np.random.SeedSequence([seed & 0xFFFFFFFF, step & 0xFFFFFFFF]))


def shard(batch: dict, n_shards: int, shard_idx: int) -> dict:
    """Slice a global batch along axis 0 for data shard ``shard_idx``."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        assert b % n_shards == 0, (k, b, n_shards)
        per = b // n_shards
        out[k] = v[shard_idx * per : (shard_idx + 1) * per]
    return out


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """LM token batches with a learnable bigram structure: token t+1 is a
    deterministic function of t with seeded noise, so cross-entropy decreases
    under training (used by the end-to-end ~100M-param training run)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1

    def batch(self, step: int) -> dict:
        r = _rng(self.seed, step)
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # fixed learnable permutation "grammar": next = (a * tok + b) % V
        a = 31 if V % 31 else 37
        start = r.integers(0, V, (B, 1))
        toks = [start]
        for _ in range(S):
            nxt = (a * toks[-1] + 17) % V
            flip = r.random((B, 1)) < self.noise
            nxt = np.where(flip, r.integers(0, V, (B, 1)), nxt)
            toks.append(nxt)
        seq = np.concatenate(toks, axis=1).astype(np.int32)  # (B, S+1)
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}


@dataclasses.dataclass(frozen=True)
class BinaryMnistStream:
    """Paper App. A setup: 784-dim 1-bit unsigned vectors, 2 classes.  Two
    fixed prototype masks + per-sample bit flips — linearly separable at the
    ~92% level, matching the paper's 91.5% 1-layer baseline regime."""

    global_batch: int
    seed: int = 0
    flip: float = 0.18

    def batch(self, step: int) -> dict:
        r = _rng(self.seed, step)
        proto_rng = _rng(self.seed, -1)
        protos = (proto_rng.random((2, 784)) < 0.35).astype(np.int8)  # fixed
        labels = r.integers(0, 2, (self.global_batch,))
        base = protos[labels]
        flips = r.random((self.global_batch, 784)) < self.flip
        x = np.where(flips, 1 - base, base).astype(np.float32)  # 1-bit unsigned
        return {"x": x, "y": labels.astype(np.int32)}


@dataclasses.dataclass(frozen=True)
class ImageClassStream:
    """CIFAR10-shaped (32x32x3, 10 classes): class = fixed random template +
    Gaussian noise; learnable by small convnets to high accuracy."""

    global_batch: int
    n_classes: int = 10
    seed: int = 0
    noise: float = 0.35

    def batch(self, step: int) -> dict:
        r = _rng(self.seed, step)
        tmpl_rng = _rng(self.seed, -1)
        templates = tmpl_rng.normal(0, 1, (self.n_classes, 32, 32, 3)).astype(np.float32)
        labels = r.integers(0, self.n_classes, (self.global_batch,))
        x = templates[labels] + r.normal(0, self.noise, (self.global_batch, 32, 32, 3))
        return {"x": x.astype(np.float32), "y": labels.astype(np.int32)}


@dataclasses.dataclass(frozen=True)
class SuperResStream:
    """BSD300-shaped SISR patches: smooth random fields; input is the 3x
    box-downsampled field, target the full-res field (PSNR-meaningful)."""

    global_batch: int
    hr: int = 48
    factor: int = 3
    seed: int = 0

    def batch(self, step: int) -> dict:
        r = _rng(self.seed, step)
        B, H = self.global_batch, self.hr
        base = r.normal(0, 1, (B, H // 4, H // 4, 1)).astype(np.float32)
        # smooth upsample -> natural-image-ish low-frequency content
        import math

        hr = base
        while hr.shape[1] < H:
            nh = min(hr.shape[1] * 2, H)
            hr = _bilinear(hr, nh)
        lr = hr.reshape(B, H // self.factor, self.factor, H // self.factor, self.factor, 1).mean((2, 4))
        return {"lr": lr.astype(np.float32), "hr": hr.astype(np.float32)}


def _bilinear(x: np.ndarray, size: int) -> np.ndarray:
    B, H, W, C = x.shape
    idx = np.linspace(0, H - 1, size)
    i0 = np.floor(idx).astype(int)
    i1 = np.minimum(i0 + 1, H - 1)
    w1 = (idx - i0)[None, :, None, None]
    rows = x[:, i0] * (1 - w1) + x[:, i1] * w1
    cols = rows[:, :, i0] * (1 - w1.transpose(0, 2, 1, 3)) + rows[:, :, i1] * w1.transpose(0, 2, 1, 3)
    return cols
