"""Blocked Gibbs sampling for the conjugate HMM (FFBS + conjugate draws).

The reference's capability set includes "Gibbs-style comparisons"
(BASELINE.json north_star; the NIPS-2014 experiments compare SVI against
samplers). This engine provides that comparison axis natively: a blocked
Gibbs sweep alternating

  1. z | theta  — exact joint draw of the state path by forward-filter
     backward-sampling (messages.ffbs_sample), vmapped over sequences;
  2. theta | z  — conjugate posterior draws: pi, A-rows ~ Dirichlet(prior +
     counts), emission params ~ NIW/Dirichlet posterior given hard counts.

Everything is device-side (`lax.scan` over sweeps, PRNG in state).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..distributions import dirichlet
from ..models.hmm import HMMParams, emission_flat_stats
from ..distributions.emissions import (
    DiagonalGaussianNIG,
    GaussianNIW,
    MultinomialDirichlet,
)
from .. import messages
from ..utils.precision import f32_matmuls


class GibbsState(NamedTuple):
    z: jax.Array  # (B, T) int32 current state paths
    theta: Any  # (pi (K,), A (K, K), emission point params)
    key: jax.Array


def _count_stats(z: jax.Array, K: int, dtype):
    """Initial/transition counts from hard paths via one-hot matmuls."""
    oh = jax.nn.one_hot(z, K, dtype=dtype)  # (B, T, K)
    init_counts = jnp.sum(oh[:, 0, :], axis=0)
    trans_counts = jnp.einsum("bti,btj->ij", oh[:, :-1, :], oh[:, 1:, :])
    return init_counts, trans_counts, oh


def make_sweep(emission, K: int):
    def sweep(state: GibbsState, prior: HMMParams, obs: jax.Array):
        key, k_pi, k_A, k_emit, k_z = jax.random.split(state.key, 5)
        dtype = prior.init.dtype

        # --- z | theta ---------------------------------------------------
        # (z first so the data-seeded initial theta drives the first sweep)
        pi_cur, A_cur, theta_cur = state.theta
        log_pi = jnp.log(pi_cur)
        log_A = jnp.log(A_cur)
        ll = emission.point_log_likelihood(theta_cur, obs)  # (B, T, K)
        B = obs.shape[0]
        zkeys = jax.random.split(k_z, B)
        z = jax.vmap(lambda k, l: messages.ffbs_sample(k, log_pi, log_A, l))(zkeys, ll)

        # --- theta | z ---------------------------------------------------
        init_counts, trans_counts, oh = _count_stats(z, K, dtype)
        pi = jax.random.dirichlet(k_pi, prior.init + init_counts)
        A = jax.random.dirichlet(k_A, prior.trans + trans_counts)
        emit_stats = emission_flat_stats(emission, prior.emit, oh, obs)
        emit_post = emission.posterior(prior.emit, emit_stats)
        theta_emit = emission.sample_params(k_emit, emit_post)

        # Data marginal likelihood under the swept params (monitoring).
        _, log_z_filt = jax.vmap(lambda l: messages.forward(log_pi, log_A, l))(ll)
        metrics = {"marginal_loglik": jnp.sum(log_z_filt)}

        return GibbsState(z=z, theta=(pi, A, theta_emit), key=key), metrics

    return jax.jit(f32_matmuls(sweep))


def init_state(key: jax.Array, prior: HMMParams, emission, obs: jax.Array, K: int) -> GibbsState:
    k_z, k_t, k_m, key = jax.random.split(key, 4)
    B, T = obs.shape[0], obs.shape[1]
    z0 = jax.random.randint(k_z, (B, T), 0, K).astype(jnp.int32)
    pi0 = jnp.full((K,), 1.0 / K, prior.init.dtype)
    A0 = jnp.full((K, K), 1.0 / K, prior.init.dtype)
    theta0 = emission.sample_params(k_t, prior.emit)
    if emission in (GaussianNIW, DiagonalGaussianNIG):
        # Seed means at farthest-point data locations (like the VB init):
        # prior-mean draws sit at the prior mean and mix badly on offset data.
        from ..models.hmm import _farthest_point_means

        flat = obs.reshape(-1, obs.shape[-1]).astype(prior.emit.mean.dtype)
        mu0 = _farthest_point_means(k_m, flat, K)
        theta0 = (mu0, theta0[1])
    return GibbsState(z=z0, theta=(pi0, A0, theta0), key=key)


def run(
    state: GibbsState,
    prior: HMMParams,
    obs: jax.Array,
    emission,
    K: int,
    num_sweeps: int,
) -> tuple[GibbsState, dict]:
    sweep = make_sweep(emission, K)

    def body(s, _):
        s2, m = sweep(s, prior, obs)
        return s2, m

    final, metrics = jax.lax.scan(body, state, None, length=num_sweeps)
    return final, metrics
