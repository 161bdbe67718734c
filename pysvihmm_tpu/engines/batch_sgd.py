"""Batch VB by natural-gradient SGD (reference ``hmmbatchsgd.py``).

Reconstructed behavior (SURVEY.md §3B): identical full-data local step to
coordinate ascent, but the global update is the damped natural-gradient
blend lambda <- (1-rho_t) lambda + rho_t (prior + full-data stats) with
rho_t = (t + tau)^(-kappa) — the bridge between batch VB and SVI. With
rho = 1 it reproduces ``hmmbatchcd`` exactly (property-tested).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..distributions import dirichlet
from ..models.hmm import HMMParams
from ..utils.schedules import power_schedule
from .base import batch_local_step, elbo_from_stats
from ..utils.precision import f32_matmuls


class BatchSGDState(NamedTuple):
    params: HMMParams
    step: jax.Array


def make_step(emission, tau: float = 1.0, kappa: float = 0.6, method: str = "auto"):
    @jax.jit
    @f32_matmuls
    def step(state: BatchSGDState, prior: HMMParams, obs: jax.Array):
        params = state.params
        stats, _ = batch_local_step(params, emission, obs, method, need_gamma=False)
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        rho = power_schedule(state.step.astype(params.init.dtype), tau, kappa)
        new_params = HMMParams(
            init=dirichlet.nat_grad_step(params.init, prior.init, stats.init, 1.0, rho),
            trans=dirichlet.nat_grad_step(
                params.trans, prior.trans, stats.trans, 1.0, rho
            ),
            emit=emission.nat_grad_step(params.emit, prior.emit, stats.emit, 1.0, rho),
        )
        return BatchSGDState(params=new_params, step=state.step + 1), elbo

    return step


def init_state(params: HMMParams) -> BatchSGDState:
    return BatchSGDState(params=params, step=jnp.asarray(0, jnp.int32))


def fit_state(
    state: BatchSGDState,
    prior: HMMParams,
    obs: jax.Array,
    emission,
    num_iters: int = 100,
    tau: float = 1.0,
    kappa: float = 0.6,
    method: str = "auto",
) -> tuple[BatchSGDState, jax.Array]:
    """State-in/state-out fit so callers can run in segments (periodic
    held-out scoring, checkpointing) without restarting the rho_t schedule
    — the step counter rides in the state."""

    @f32_matmuls
    def body(s, _):
        params = s.params
        stats, _ = batch_local_step(params, emission, obs, method, need_gamma=False)
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        rho = power_schedule(s.step.astype(params.init.dtype), tau, kappa)
        new_params = HMMParams(
            init=dirichlet.nat_grad_step(params.init, prior.init, stats.init, 1.0, rho),
            trans=dirichlet.nat_grad_step(
                params.trans, prior.trans, stats.trans, 1.0, rho
            ),
            emit=emission.nat_grad_step(params.emit, prior.emit, stats.emit, 1.0, rho),
        )
        return BatchSGDState(params=new_params, step=s.step + 1), elbo

    return jax.lax.scan(body, state, None, length=num_iters)


def fit(
    params: HMMParams,
    prior: HMMParams,
    obs: jax.Array,
    emission,
    num_iters: int = 100,
    tau: float = 1.0,
    kappa: float = 0.6,
    method: str = "auto",
) -> tuple[HMMParams, jax.Array]:
    final, elbos = fit_state(
        init_state(params), prior, obs, emission, num_iters, tau, kappa, method
    )
    return final.params, elbos
