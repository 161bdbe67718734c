"""Fault-tolerant training driver: periodic checkpoint + resume-on-restart.

SURVEY.md §5 "failure detection / elastic recovery": the reference has none;
long SVI runs need restartable runs whose (t + tau)^(-kappa) schedule (and
elastic-step state) survives preemption. This driver wraps any
(state, prior, obs) -> (state, metrics) step function with:

  * periodic atomic checkpoints (utils/checkpoint.save_step);
  * automatic resume from the latest checkpoint in the directory;
  * NaN watchdog (jax.debug-free: a host-side check every watchdog_every
    steps — UNCONDITIONAL, logger or not — that aborts with a clear error
    instead of silently diverging).

Multi-host deployments (`jax.distributed`) pass the SAME shared-filesystem
checkpoint_dir on EVERY process: writes are gated on process 0 (state is
replicated, one copy suffices), but every process RESTORES from it — a
host that skipped the restore would re-enter the collectives at step 0
while host 0 resumes mid-run, deadlocking the psums. Restore happens
before any collective, so ordering vs `jax.distributed.initialize` is
trivially safe (tests/test_multihost.py::test_two_process_trainer_resume).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import numpy as np

from ..utils import checkpoint
from ..utils.logging import MetricsLogger


def _save(checkpoint_dir: str, step: int, state: Any) -> None:
    """Checkpoint write, process-0-gated: replicated state needs one copy,
    and N processes racing the same atomic rename on a shared filesystem
    need not be tested."""
    if jax.process_index() == 0:
        checkpoint.save_step(checkpoint_dir, step, state)


def train(
    step_fn: Callable,
    state: Any,
    prior: Any,
    obs: Any,
    num_steps: int,
    *,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1000,
    log: MetricsLogger | None = None,
    log_every: int = 100,
    watchdog_every: int | None = None,
    resume: bool = True,
) -> Any:
    """Run step_fn up to num_steps total (counting resumed progress).

    The NaN watchdog runs every ``watchdog_every`` steps (default: same
    cadence as ``log_every``) whether or not a logger is attached — a
    logger-less run must abort on divergence, not proceed silently.
    """
    if checkpoint_dir and resume:
        latest = checkpoint.latest_step_path(checkpoint_dir)
        if latest is not None:
            state = checkpoint.restore(latest, state)
    if watchdog_every is None:
        watchdog_every = log_every

    start = int(np.asarray(jax.device_get(state.step)))
    metrics = None
    for i in range(start, num_steps):
        state, metrics = step_fn(state, prior, obs)
        done = i + 1
        check = done % watchdog_every == 0
        emit = log is not None and done % log_every == 0
        if check or emit:
            host_metrics = {k: float(np.asarray(jax.device_get(v))) for k, v in metrics.items()}
            if not all(np.isfinite(v) for v in host_metrics.values()):
                raise FloatingPointError(
                    f"non-finite objective at step {done}: {host_metrics}"
                )
            if emit:
                log.write(step=done, **host_metrics)
        if checkpoint_dir and done % checkpoint_every == 0:
            _save(checkpoint_dir, done, state)
    if checkpoint_dir and num_steps > start:
        _save(checkpoint_dir, num_steps, state)
    return state


def train_streamed(
    step_fn: Callable,
    state: Any,
    prior: Any,
    loader: Any,
    num_steps: int,
    *,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1000,
    log: MetricsLogger | None = None,
    log_every: int = 100,
    watchdog_every: int | None = None,
    resume: bool = True,
) -> Any:
    """Fault-tolerant streamed training: one loader batch per step.

    Same contract as :func:`train` but the data arrives from a
    :class:`~pysvihmm_tpu.data.loader.ShardedSequenceLoader`-style object
    exposing ``stream(start_step)`` (deterministic, resumable). Because the
    stream position is a pure function of the step counter — which rides in
    the checkpointed state alongside the PRNG key, the (t + tau)^(-kappa)
    schedule and any elastic-step moments — a killed run restarted from the
    latest checkpoint consumes exactly the batches the uninterrupted run
    would have (tests/test_trainer.py::test_streamed_kill_resume_bitexact).
    This is the path the flagship 1M-sequence runner drives
    (scripts/run_config5_scale.py).
    """
    if checkpoint_dir and resume:
        latest = checkpoint.latest_step_path(checkpoint_dir)
        if latest is not None:
            state = checkpoint.restore(latest, state)
    if watchdog_every is None:
        watchdog_every = log_every

    start = int(np.asarray(jax.device_get(state.step)))
    it = loader.stream(start_step=start)
    for i in range(start, num_steps):
        batch = next(it)
        state, metrics = step_fn(state, prior, batch)
        done = i + 1
        check = done % watchdog_every == 0
        emit = log is not None and done % log_every == 0
        if check or emit:
            host_metrics = {k: float(np.asarray(jax.device_get(v))) for k, v in metrics.items()}
            if not all(np.isfinite(v) for v in host_metrics.values()):
                raise FloatingPointError(
                    f"non-finite objective at step {done}: {host_metrics}"
                )
            if emit:
                log.write(step=done, **host_metrics)
        if checkpoint_dir and done % checkpoint_every == 0:
            _save(checkpoint_dir, done, state)
    if checkpoint_dir and num_steps > start:
        _save(checkpoint_dir, num_steps, state)
    return state
