"""Structured metrics logging (SURVEY.md §5: reference prints ELBO per
iteration; we emit JSONL records + optional stdout lines)."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Any

import jax
import numpy as np


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock stamps.

    Usage:
        log = MetricsLogger("run.jsonl")
        log.write(step=10, elbo=-123.4, rho=0.05)
    """

    def __init__(self, path: str | None = None, echo: bool = True):
        self._fh: IO[str] | None = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.perf_counter()

    def write(self, **metrics: Any) -> None:
        rec = {"wall_s": round(time.perf_counter() - self._t0, 4)}
        for k, v in metrics.items():
            if isinstance(v, (jax.Array, np.ndarray)):
                v = np.asarray(v).tolist()
            rec[k] = v
        line = json.dumps(rec)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def profile_trace(log_dir: str):
    """Context manager starting a jax.profiler trace (device timeline in
    TensorBoard) around a hot region — SURVEY.md §5 tracing subsystem."""
    return jax.profiler.trace(log_dir)
