"""Deterministic synthetic LM data pipeline (host-sharded, prefetching).

A copy of `repro/data/pipeline.py` (plain numpy): the same seed, step and
host give the same batch, byte for byte, in both packages.

The pipeline synthesizes a *learnable* token stream (order-1 Markov chains
with per-document transition tables), so a model has something to learn
without a corpus.  Each host materializes only its shard of the
global batch (`host_slice`), batches are indexed by step for exact restart
reproducibility (a checkpoint stores only the step counter), and a
background thread prefetches.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["SyntheticLMDataset", "make_train_iterator"]


class SyntheticLMDataset:
    """Step-indexed, deterministic, host-shardable synthetic corpus."""

    def __init__(
        self,
        vocab: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        n_tables: int = 8,
        branch: int = 4,
    ):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        # per-"document class" sparse Markov transitions: each token has
        # `branch` plausible successors -> cross-entropy floor ~= log(branch)
        self.tables = rng.integers(
            0, vocab, size=(n_tables, vocab, branch), dtype=np.int32
        )

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> dict:
        """Materialize this host's slice of global batch `step`."""
        assert self.global_batch % num_hosts == 0
        per_host = self.global_batch // num_hosts
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + host_id
        )
        toks = np.empty((per_host, self.seq_len + 1), dtype=np.int32)
        table_ids = rng.integers(0, len(self.tables), size=per_host)
        toks[:, 0] = rng.integers(0, self.vocab, size=per_host)
        choices = rng.integers(0, self.tables.shape[-1],
                               size=(per_host, self.seq_len))
        for t in range(self.seq_len):
            toks[:, t + 1] = self.tables[
                table_ids, toks[:, t], choices[:, t]
            ]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_train_iterator(
    dataset: SyntheticLMDataset,
    start_step: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
    prefetch: int = 2,
):
    """Background-thread prefetching iterator, resumable at `start_step`."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(
                    (step, dataset.batch(step, host_id, num_hosts)), timeout=0.5
                )
                step += 1
            except queue.Full:
                continue

    th = threading.Thread(target=worker, daemon=True)
    th.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
