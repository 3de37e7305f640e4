"""Deterministic synthetic data (port of `repro.data.synthetic`).

LM batches (`make_lm_batch`, `TokenDataset`, `FrameDataset`) are a pure
function of (seed, step), so a restarted job replays the exact stream.
They are drawn from a CPU `torch.Generator`, the same on every device;
the numbers differ from the JAX package's `jax.random` draws, so the
tests feed both packages one numpy batch.

The ANNS half is pure numpy and therefore bit-identical to the JAX
package's.

The datasets are distribution-matched stand-ins for the paper's Table 3:
clustered Gaussians on a low-intrinsic-dimension manifold (graph indices
behave qualitatively like real embeddings on these), with dims / metric /
dtype per dataset. The port keeps its own copy of the dataset table so it
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ANNSDatasetConfig:
    """Paper Table 3 dataset stand-ins (synthetic, distribution-matched)."""

    name: str
    dims: int
    metric: str
    dtype: str
    full_n: int              # the paper's size (capacity planning)
    bench_n: int             # default N for measured runs
    n_queries: int


def make_lm_batch(cfg, batch: int, seq_len: int, seed: int, step: int
                  ) -> dict[str, torch.Tensor]:
    """One batch on the CPU. Token frontends: {"tokens", "labels"} (B, S)
    int32, labels the tokens shifted left by one, uniform over the vocab.
    Frames (encoder archs): {"frames" (B, S, d_model) float32 standard
    normal, "labels" (B, S) int32 frame labels uniform over the vocab}."""
    sub = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    gen = torch.Generator().manual_seed(sub)
    if cfg.frontend == "frames":
        frames = torch.randn((batch, seq_len, cfg.d_model), generator=gen)
        labels = torch.randint(0, cfg.vocab_size, (batch, seq_len),
                               generator=gen, dtype=torch.int32)
        return {"frames": frames, "labels": labels}
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq_len + 1),
                           generator=gen, dtype=torch.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


@dataclass
class TokenDataset:
    cfg: object
    batch: int
    seq_len: int
    seed: int = 0

    def __call__(self, step: int) -> dict[str, torch.Tensor]:
        return make_lm_batch(self.cfg, self.batch, self.seq_len, self.seed,
                             step)


# the JAX package's two datasets are one function of (seed, step)
FrameDataset = TokenDataset


ANNS_DATASETS: dict[str, ANNSDatasetConfig] = {
    "bigann": ANNSDatasetConfig("bigann", 128, "l2", "uint8", 100_000_000, 12_000, 1000),
    "deep": ANNSDatasetConfig("deep", 96, "l2", "float32", 100_000_000, 12_000, 1000),
    "gist": ANNSDatasetConfig("gist", 960, "l2", "float32", 1_000_000, 8_000, 500),
    "openai": ANNSDatasetConfig("openai", 1536, "l2", "float32", 2_300_000, 6_000, 500),
    "text2image": ANNSDatasetConfig("text2image", 200, "mips", "float32", 10_000_000, 10_000, 1000),
}


def _name_seed(name: str) -> int:
    return int(np.frombuffer(name.encode().ljust(8, b"x")[:8],
                             dtype=np.uint32)[0])


def _manifold(ds: ANNSDatasetConfig, n_clusters: int = 64,
              intrinsic: int = 64):
    """Shared generative structure per dataset NAME: cluster centers living
    in a low-intrinsic-dimension subspace of the ambient space (isolated
    Gaussian islands in high ambient dimension are unnavigable for graph
    ANNS; real embeddings have low intrinsic dimension)."""
    rng = np.random.default_rng(_name_seed(ds.name))
    r = min(intrinsic, ds.dims)
    basis = rng.normal(size=(r, ds.dims)).astype(np.float32) / np.sqrt(r)
    centers_z = rng.normal(size=(n_clusters, r)).astype(np.float32)
    return basis, centers_z


def _clustered(ds: ANNSDatasetConfig, rng: np.random.Generator, n: int,
               spread: float = 0.35, ambient_noise: float = 0.02
               ) -> np.ndarray:
    basis, centers_z = _manifold(ds)
    r = basis.shape[0]
    assign = rng.integers(0, centers_z.shape[0], n)
    z = centers_z[assign] + spread * rng.normal(size=(n, r)).astype(np.float32)
    x = z @ basis + ambient_noise * rng.normal(
        size=(n, ds.dims)).astype(np.float32)
    if ds.dtype == "uint8":                       # BigANN/SIFT-style
        x = np.clip((x * 64 + 128), 0, 255).astype(np.uint8)
    return x.astype(np.float32)


def make_anns_dataset(ds: ANNSDatasetConfig, n: int | None = None,
                      seed: int = 0) -> np.ndarray:
    """Synthetic stand-in for one Table 3 dataset (bench_n rows default)."""
    n = n or ds.bench_n
    rng = np.random.default_rng(seed * 7919 + _name_seed(ds.name))
    x = _clustered(ds, rng, n)
    if ds.metric == "mips":                       # Text2Image-style norms
        scale = rng.uniform(0.5, 1.5, size=(n, 1)).astype(np.float32)
        x = x * scale
    return x


def make_queries(ds: ANNSDatasetConfig, n_queries: int | None = None,
                 seed: int = 1) -> np.ndarray:
    """Held-out queries from the same mixture (disjoint draws)."""
    nq = n_queries or ds.n_queries
    rng = np.random.default_rng(seed * 104729 + _name_seed(ds.name) + 1)
    return _clustered(ds, rng, nq)
