"""Deterministic, shardable, resumable data loader.

State = (seed, host_id, num_hosts, step).  Every batch is derived from a
counter-based RNG stream keyed by (seed, host, step), so:
  * resume-after-restart is exact (checkpoint stores only ``step``),
  * each host draws a disjoint stream (data parallel across processes),
  * elastic re-sharding just changes (host_id, num_hosts) going forward.
A tiny background prefetch thread hides generation latency.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data.synth import SyntheticTask


@dataclasses.dataclass
class LoaderState:
    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


class DataLoader:
    def __init__(self, task: SyntheticTask, batch_size: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 prefetch: int = 2):
        self.task, self.batch_size, self.seq_len = task, batch_size, seq_len
        self.seed, self.host_id, self.num_hosts = seed, host_id, num_hosts
        self.state = LoaderState()
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- core ------------------------------------------------------------------

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, step]))
        rows = [self.task.render(rng, self.seq_len) for _ in range(self.batch_size)]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}

    def next(self) -> Dict[str, np.ndarray]:
        if self._q is not None:
            b = self._q.get()
        else:
            b = self._batch_at(self.state.step)
        self.state.step += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    # -- prefetch ----------------------------------------------------------------

    def start_prefetch(self):
        if self._thread is not None:
            return
        self._q = queue.Queue(maxsize=self._prefetch)
        start = self.state.step

        def worker():
            s = start
            while not self._stop.is_set():
                try:
                    self._q.put(self._batch_at(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop_prefetch(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._thread, self._q = None, None
        self._stop = threading.Event()

    # -- checkpoint integration -----------------------------------------------------

    def state_dict(self):
        return self.state.to_dict()

    def load_state_dict(self, d):
        restarting_prefetch = self._thread is not None
        if restarting_prefetch:
            self.stop_prefetch()
        self.state = LoaderState.from_dict(d)
        if restarting_prefetch:
            self.start_prefetch()
