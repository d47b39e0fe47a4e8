"""Deterministic synthetic data pipeline, host-sharded, restart-safe: the
reference's numpy-only ``data/pipeline.py``, copied so that the port's
batches are bit-identical to the reference's.

  * **Stateless addressing**: batch ``i`` is a pure function of
    ``(seed, step)`` — restart at step N regenerates exactly the stream a
    checkpoint expects, with no data-state to snapshot and no replay log.
  * **Host sharding**: each host materializes only its slice of the global
    batch (``host_id / num_hosts``).
  * **Prefetch**: a background thread keeps ``depth`` batches ahead so host
    data generation overlaps device compute.

The synthetic LM stream is a deterministic mixture (Zipfian unigram +
shift-structured spans) so losses are reproducible across runs and the
pipeline cost is realistic (vocab-range integers, not zeros).  Batches are
numpy arrays; the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    prefix_len: int = 0          # vlm: patch positions at the front
    d_model: int = 0             # for embeds/frames stubs
    mode: str = "tokens"         # tokens | embeds_prefix | frames


class SyntheticLMDataset:
    """Deterministic per-step synthetic batches (host-sharded)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id]))
        B, S = self.local_batch, cfg.seq_len
        # Zipfian unigrams with shift structure (next-token partially
        # predictable => loss actually decreases when training works).
        zipf = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        base = np.minimum(zipf, cfg.vocab - 2).astype(np.int32)
        shifted = np.roll(base, 1, axis=1)
        use_prev = rng.random((B, S)) < 0.5
        tokens = np.where(use_prev, shifted, base).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        out = {"tokens": tokens, "labels": labels,
               "loss_mask": np.ones((B, S), np.float32)}
        if cfg.mode == "embeds_prefix":
            out["embeds"] = rng.standard_normal(
                (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
            out["loss_mask"][:, :1] = 0.0
        elif cfg.mode == "frames":
            out["frames"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def prefetch(it: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Background-thread prefetch."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
