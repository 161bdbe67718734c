"""Dirichlet distribution module (rows of conjugate Dirichlet posteriors).

Replacement for the Dirichlet machinery the reference delegates to
``pybasicbayes`` plus the E[log pi]/E[log A] helpers in ``pysvihmm/hmmbase.py``
(reconstructed — see SURVEY.md §2.2; the reference mount was empty, so parity
is against the math of Foti et al. 2014, arXiv:1411.1670).

All functions are pure jnp, broadcast over arbitrary leading axes, with the
simplex on the LAST axis. A (K, K) array is K independent Dirichlet rows
(e.g. the transition-matrix posterior); a (K, V) array is K emission rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln


def expected_log_probs(alpha: jax.Array) -> jax.Array:
    """E_q[log x] for x ~ Dir(alpha), elementwise over leading axes.

    E[log x_i] = psi(alpha_i) - psi(alpha_0) with alpha_0 = sum_i alpha_i.
    This is the quantity the reference exponentiates to form the variational
    transition matrix A~ = exp(E[log A]) used inside forward-backward.
    """
    return digamma(alpha) - digamma(jnp.sum(alpha, axis=-1, keepdims=True))


def log_normalizer(alpha: jax.Array) -> jax.Array:
    """log B(alpha) = sum_i lgamma(alpha_i) - lgamma(sum_i alpha_i)."""
    return jnp.sum(gammaln(alpha), axis=-1) - gammaln(jnp.sum(alpha, axis=-1))


def kl(q_alpha: jax.Array, p_alpha: jax.Array) -> jax.Array:
    """KL(Dir(q_alpha) || Dir(p_alpha)) per row (leading axes preserved)."""
    q0 = jnp.sum(q_alpha, axis=-1)
    elog = digamma(q_alpha) - digamma(q0)[..., None]
    return (
        -log_normalizer(q_alpha)
        + log_normalizer(p_alpha)
        + jnp.sum((q_alpha - p_alpha) * elog, axis=-1)
    )


def posterior(prior_alpha: jax.Array, stats: jax.Array) -> jax.Array:
    """Exact conjugate mean-field update: alpha_post = alpha_prior + E[counts]."""
    return prior_alpha + stats


def nat_grad_step(
    q_alpha: jax.Array,
    prior_alpha: jax.Array,
    stats: jax.Array,
    scale: jax.Array | float,
    rho: jax.Array | float,
) -> jax.Array:
    """Natural-gradient SVI step (Hoffman et al. 2013).

    q <- (1 - rho) * q + rho * (prior + scale * stats)

    ``scale`` is the unbiasedness factor turning minibatch expected counts
    into a full-dataset estimate. With rho=1, scale=1 and full-data stats this
    reduces exactly to :func:`posterior` (property-tested).
    """
    return (1.0 - rho) * q_alpha + rho * (prior_alpha + scale * stats)


def mean(alpha: jax.Array) -> jax.Array:
    """Posterior mean point estimate (plug-in for predictive scoring)."""
    return alpha / jnp.sum(alpha, axis=-1, keepdims=True)


def sample(key: jax.Array, alpha: jax.Array) -> jax.Array:
    """Draw from Dir(alpha), batched over leading axes (for Gibbs engines)."""
    return jax.random.dirichlet(key, alpha)
