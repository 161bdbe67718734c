"""Host-sharded data loading for corpora larger than one host (BASELINE config 5).

The reference loads everything into one NumPy array (single host). For a
1M-sequence corpus across hosts, each process materializes only its own
shard and assembles a globally-sharded jax.Array without cross-host traffic
(SURVEY.md §5 "multi-host input pipeline ... without host OOM").
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def process_shard_bounds(total: int, num_processes: int, process_id: int) -> tuple[int, int]:
    """Contiguous [start, end) slice of the corpus owned by this process."""
    per = total // num_processes
    rem = total % num_processes
    start = process_id * per + min(process_id, rem)
    return start, start + per + (1 if process_id < rem else 0)


class ShardedSequenceLoader:
    """Minibatch iterator over a host-sharded (N, T, ...) corpus.

    load_shard(start, end) is the user's IO function (memmap, parquet, ...);
    it runs once per host for its own slice only. Batches are returned as
    globally-sharded arrays over the mesh's 'data' axis, one epoch-shuffled
    pass at a time, with per-host local shuffling (no cross-host gather).
    """

    def __init__(
        self,
        load_shard: Callable[[int, int], np.ndarray],
        total: int,
        mesh: Mesh,
        batch_per_host: int,
        seed: int = 0,
    ):
        self.mesh = mesh
        self.batch_per_host = batch_per_host
        pid = jax.process_index()
        nproc = jax.process_count()
        self.start, self.end = process_shard_bounds(total, nproc, pid)
        self.local = np.asarray(load_shard(self.start, self.end))
        self.seed = seed
        self.rng = np.random.default_rng(seed + pid)
        self.sharding = NamedSharding(mesh, P("data"))

    @classmethod
    def from_npy(
        cls, path: str, mesh: Mesh, batch_per_host: int, seed: int = 0
    ) -> "ShardedSequenceLoader":
        """Memory-mapped ``.npy`` corpus: the OS pages in only the rows each
        batch actually touches, so a 1M-sequence file never materializes in
        host RAM (the fancy-index in ``__iter__`` copies just the batch)."""
        arr = np.load(path, mmap_mode="r")
        return cls(lambda s, e: arr[s:e], len(arr), mesh, batch_per_host, seed)

    def __iter__(self) -> Iterator[jax.Array]:
        order = self.rng.permutation(len(self.local))
        for i in range(0, len(order) - self.batch_per_host + 1, self.batch_per_host):
            # fancy indexing copies ONLY these rows (memmap shards stay on disk)
            batch = np.ascontiguousarray(self.local[order[i : i + self.batch_per_host]])
            yield jax.make_array_from_process_local_data(self.sharding, batch)

    def batches_per_epoch(self) -> int:
        """Whole batches per epoch (the tail < batch_per_host is dropped,
        matching ``__iter__``'s range arithmetic)."""
        return len(self.local) // self.batch_per_host

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The shuffle permutation of epoch ``epoch`` — a pure function of
        (seed, process, epoch), so any (epoch, batch) position in the stream
        can be re-derived exactly after a restart (no RNG state to persist;
        the fault-tolerant trainer resumes mid-corpus from the step counter
        alone — SURVEY.md §5 failure detection / elastic recovery)."""
        rng = np.random.default_rng((self.seed, jax.process_index(), epoch))
        return rng.permutation(len(self.local))

    def stream(self, start_step: int = 0, depth: int = 2) -> Iterator[jax.Array]:
        """Infinite resumable batch stream, prefetched.

        Batch ``s`` of the stream is batch ``s % batches_per_epoch()`` of
        epoch ``s // batches_per_epoch()`` under :meth:`epoch_order` — fully
        deterministic, so a run restarted with ``start_step = steps_done``
        sees exactly the batches the uninterrupted run would have seen.
        """
        B = self.batch_per_host
        bpe = self.batches_per_epoch()
        if bpe == 0:
            raise ValueError(
                f"shard has {len(self.local)} sequences < batch_per_host={B}"
            )

        def gen():
            step = start_step
            while True:
                epoch, idx = divmod(step, bpe)
                order = self.epoch_order(epoch)
                for i in range(idx, bpe):
                    batch = np.ascontiguousarray(self.local[order[i * B : (i + 1) * B]])
                    yield jax.make_array_from_process_local_data(self.sharding, batch)
                    step += 1

        return _prefetch_iter(gen(), depth)

    def prefetch(self, depth: int = 2) -> Iterator[jax.Array]:
        """One epoch with the host work pipelined ahead of device compute.

        The plain ``__iter__`` performs the memmap gather + host->device
        copy synchronously between steps, so the device idles for the
        full IO+transfer time of every batch. This wraps the same epoch in
        a daemon thread feeding a ``depth``-deep queue: while the device
        runs step t, the thread gathers and ships batches t+1..t+depth,
        overlapping IO and transfer with compute (transfer-bound links
        degrade gracefully to the link rate instead of IO+transfer+compute
        in series). The thread dies with the iterator; a poison pill
        propagates loader exceptions to the consumer.
        """
        return _prefetch_iter(iter(self), depth)


def _prefetch_iter(source: Iterator, depth: int) -> Iterator:
    """Drive ``source`` from a daemon thread into a ``depth``-deep queue.

    A poison pill propagates producer exceptions to the consumer; the
    thread dies with the process (daemon) if the consumer stops early.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for batch in source:
                q.put(batch)
            q.put(_END)
        except BaseException as e:  # propagate into the consuming thread
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
