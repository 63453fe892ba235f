"""Token data pipeline: deterministic synthetic corpus + memory-mapped
token files, per-host sharding, and a background prefetcher.

The port's own copy of the reference's numpy pipeline, line for line: the
reference package's import loads jax, so the port cannot import it, and
`batch(step)` must give the reference's bits for the two packages to
train on the same tokens.

Determinism contract: batch(step) is a pure function of (seed, step,
host_slice) — restart-after-failure resumes bit-identically from the
checkpointed step without replaying the stream.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLMDataset:
    """Zipf-distributed token stream; batch(step) is stateless."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, num_hosts: int = 1, host_id: int = 0,
                 zipf_a: float = 1.2):
        assert global_batch % num_hosts == 0
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        self.zipf_a = zipf_a
        # fixed rank permutation so ids aren't trivially ordered by freq
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab_size)

    def batch(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        z = rng.zipf(self.zipf_a, size=(self.local_batch, self.seq_len + 1))
        return self.perm[np.minimum(z - 1, self.vocab_size - 1)].astype(
            np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class TokenFileDataset:
    """Memory-mapped flat token file (.bin int32/uint16), sequential
    chunking with per-host striding; batch(step) stateless."""

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 dtype=np.int32, num_hosts: int = 1, host_id: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.local_batch = global_batch // num_hosts
        self.global_batch = global_batch
        self.host_id = host_id
        self.n_windows = (len(self.tokens) - 1) // seq_len

    def batch(self, step: int) -> np.ndarray:
        idx0 = (step * self.global_batch
                + self.host_id * self.local_batch) % self.n_windows
        rows = []
        for i in range(self.local_batch):
            w = (idx0 + i) % self.n_windows
            s = w * self.seq_len
            rows.append(np.asarray(self.tokens[s:s + self.seq_len + 1]))
        return np.stack(rows).astype(np.int32)


class Prefetcher:
    """Background-thread prefetch of (step, batch) pairs."""

    def __init__(self, dataset, start_step: int = 0, depth: int = 2):
        self.dataset = dataset
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.dataset.batch(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        while not self.q.empty():
            self.q.get_nowait()
