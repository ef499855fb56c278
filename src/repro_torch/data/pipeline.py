"""Deterministic, sharded input pipeline with exact resume.

Counterpart of `repro.data.pipeline`: a numpy copy, so a batch here is
byte for byte the JAX package's for the same (config, step).

Two sources:
  synthetic   counter-based PRNG tokens — each (step, host_shard) batch is a
              pure function of (seed, step), so restart at step k reproduces
              byte-identical batches with zero stored state.
  memmap      fixed-length token documents in a flat .bin (np.memmap);
              deterministic shuffled window order from (seed, epoch).

Both shard the global batch across data-parallel hosts: host h of H gets
rows [h*B/H, (h+1)*B/H).  Resume = construct loader with the same seed and
call `loader.batch(step)` — no iterator state to checkpoint beyond the step
counter that the training checkpoint already holds.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    source: str = "synthetic"        # synthetic | memmap
    path: str | None = None          # memmap token file
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0, \
            f"global_batch {self.global_batch} % n_hosts {self.n_hosts}"
        return self.global_batch // self.n_hosts


class ShardedLoader:
    """batch(step) -> {"tokens", "labels", "mask"} for this host's shard."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.source == "memmap":
            if cfg.path is None:
                raise ValueError("memmap source needs cfg.path")
            self._data = np.memmap(cfg.path, dtype=np.int32, mode="r")
            self._n_windows = len(self._data) // (cfg.seq_len + 1)
            if self._n_windows < 1:
                raise ValueError("memmap file shorter than one window")

    # -- deterministic per-(step, row) token generation -------------------
    def _synthetic_rows(self, step: int) -> np.ndarray:
        cfg = self.cfg
        row0 = step * cfg.global_batch + cfg.host_id * cfg.host_batch
        out = np.empty((cfg.host_batch, cfg.seq_len + 1), np.int32)
        for i in range(cfg.host_batch):
            # Philox counter PRNG keyed by (seed, global_row) — O(1) seek.
            rng = np.random.Generator(
                np.random.Philox(key=cfg.seed, counter=row0 + i))
            # Zipf-ish marginals so losses resemble text, not uniform noise.
            z = rng.zipf(1.3, size=cfg.seq_len + 1)
            out[i] = np.minimum(z, cfg.vocab - 1)
        return out

    def _memmap_rows(self, step: int) -> np.ndarray:
        cfg = self.cfg
        W = cfg.seq_len + 1
        epoch, within = divmod(step * cfg.global_batch, self._n_windows)
        order = np.random.Generator(
            np.random.Philox(key=cfg.seed + epoch)).permutation(
                self._n_windows)
        row0 = within + cfg.host_id * cfg.host_batch
        idx = order[(row0 + np.arange(cfg.host_batch)) % self._n_windows]
        return np.stack([self._data[j * W:(j + 1) * W] for j in idx]) \
            .astype(np.int32)

    def batch(self, step: int) -> dict:
        rows = (self._synthetic_rows(step) if self.cfg.source == "synthetic"
                else self._memmap_rows(step))
        return {"tokens": rows[:, :-1],
                "labels": rows[:, 1:],
                "mask": np.ones((self.cfg.host_batch, self.cfg.seq_len),
                                np.float32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_loader(cfg, shape: dict, *, seed=0, source="synthetic", path=None,
                n_hosts=1, host_id=0) -> ShardedLoader:
    """cfg: ModelConfig; shape: one of `configs.base.SHAPES`' values."""
    return ShardedLoader(DataConfig(
        seq_len=shape["seq_len"], global_batch=shape["global_batch"],
        vocab=cfg.vocab, seed=seed, source=source, path=path,
        n_hosts=n_hosts, host_id=host_id))
