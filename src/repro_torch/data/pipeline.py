"""Deterministic, seekable, host-shardable data pipeline.

Port of ``repro.data.pipeline`` (numpy only, as there): the same seed,
step and shard give the reference's batches byte for byte.

Training restarts must be bit-exact: batch t is a pure function of
(seed, step, host_shard), so resuming from a checkpoint at step k replays
exactly the batches k, k+1, ... with no iterator state to persist. Synthetic
LM data comes from a counter-based generator (threefry via jax on host
numpy is too slow at scale — we use a splitmix64-style hash, vectorized)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _hash_tokens(seed: int, step: int, shard: int, n: int, vocab: int,
                 salt: int = 0) -> np.ndarray:
    base = (np.uint64(seed) << np.uint64(40)) ^ (np.uint64(step) << np.uint64(16)) \
        ^ np.uint64(shard) ^ (np.uint64(salt) << np.uint64(56))
    idx = np.arange(n, dtype=np.uint64) + (base << np.uint64(1))
    with np.errstate(over="ignore"):
        h = _splitmix64(idx)
    return (h % np.uint64(vocab)).astype(np.int32)


@dataclasses.dataclass
class SyntheticLMData:
    """Markov-flavored synthetic token stream: next token depends on the
    previous one (so a trained model shows decreasing loss — used by the
    example trainer), with a deterministic seekable layout."""

    cfg: ModelConfig
    shape: ShapeSpec
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    structure: float = 0.75    # P(next = f(prev)); rest uniform

    def batch_at(self, step: int) -> Dict[str, Any]:
        B = self.shape.global_batch // self.num_hosts
        S = self._text_len()
        V = self.cfg.vocab_size
        raw = _hash_tokens(self.seed, step, self.host_id, B * (S + 1), V)
        raw = raw.reshape(B, S + 1)
        gate = _hash_tokens(self.seed, step, self.host_id, B * (S + 1), 1_000_000,
                            salt=1).reshape(B, S + 1)
        toks = raw.copy()
        for t in range(1, S + 1):  # vectorized over batch
            structured = (toks[:, t - 1] * 31 + 7) % V
            use = gate[:, t] < int(self.structure * 1_000_000)
            toks[:, t] = np.where(use, structured, raw[:, t])
        batch = {"tokens": toks[:, :S].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        return self._add_frontends(batch, step, B, S)

    def _text_len(self) -> int:
        S = self.shape.seq_len
        if self.cfg.is_encoder_decoder:
            return S // self.cfg.decoder_ratio
        if self.cfg.frontend == "vision":
            return S - self.cfg.num_prefix_embeddings
        return S

    def _add_frontends(self, batch, step, B, S):
        d = self.cfg.d_model
        if self.cfg.is_encoder_decoder:
            n = B * self.shape.seq_len * d
            h = _hash_tokens(self.seed, step, self.host_id, n, 1 << 16, salt=2)
            batch["frames"] = ((h.reshape(B, self.shape.seq_len, d).astype(np.float32)
                                / (1 << 15)) - 1.0) * 0.02
        if self.cfg.frontend == "vision":
            P = self.cfg.num_prefix_embeddings
            h = _hash_tokens(self.seed, step, self.host_id, B * P * d, 1 << 16,
                             salt=3)
            batch["prefix_embeddings"] = (
                (h.reshape(B, P, d).astype(np.float32) / (1 << 15)) - 1.0) * 0.02
        return batch

    def iterator(self, start_step: int = 0) -> Iterator[Dict[str, Any]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def data_iter(cfg: ModelConfig, shape: ShapeSpec, *, seed: int = 0,
              start_step: int = 0, num_hosts: int = 1, host_id: int = 0):
    return SyntheticLMData(cfg, shape, seed, num_hosts, host_id
                           ).iterator(start_step)
