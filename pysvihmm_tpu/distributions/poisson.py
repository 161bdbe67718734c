"""Poisson emissions under per-dimension conjugate Gamma priors.

An EXTENSION family beyond the reference's Gaussian/Multinomial pair
(``pysvihmm/hmmbase.py`` var_emit lists, reconstructed — SURVEY.md §2.2):
per-state count vectors y in N^D with independent rates,

    y_d ~ Poisson(lambda_d);   lambda_d ~ Gamma(a_d, b_d)   (rate b).

Same four-method contract as :mod:`.niw` / :mod:`.diag_gaussian`
(``expected_log_likelihood`` / ``posterior`` / ``nat_grad_step`` / ``kl``),
so every engine (batch VB, SGD, SVI, meta-obs, Gibbs) and every FB path
works unchanged.

Design notes:
  * The expected log-likelihood is LINEAR in the per-observation features
    [1, y, sum_d log y_d!] (width 2 + D):
        E[log p(y | lambda_k)] = sum_d ( y_d E[log lambda_kd] - E[lambda_kd] )
                                 - sum_d log y_d!
    with E[log lambda] = digamma(a) - log b and E[lambda] = a / b. The
    log-factorial feature carries a CONSTANT -1 weight for every state: it
    cancels in the FB posterior but keeps log_z / the ELBO exact. Both the
    likelihood matmul and the sufficient-stat contraction of the fused
    kernels consume this one (T, B, 2+D) array.
  * Sufficient stats are t(y) = (n, sum_y): a_n = a + sum_y, b_n = b + n —
    the natural-parameter blend of the SVI step is exact conjugacy at
    rho = 1 (property-tested, mirroring the NIW/NIG families).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln


class GammaP(NamedTuple):
    """Per-dimension Gamma(a, b) rate-parameterized params, leading axes
    broadcast (canonically (K,)); both fields (..., D)."""

    a: jax.Array  # shape
    b: jax.Array  # rate


class PoissonStats(NamedTuple):
    """Weighted Poisson sufficient stats sum_t w_t * (1, y)."""

    n: jax.Array  # (...,)
    sum_y: jax.Array  # (..., D)


def make_prior(K: int, D: int, *, a: float = 1.0, b: float = 1.0,
               dtype=jnp.float32) -> GammaP:
    """Weakly-informative Gamma prior replicated over K states
    (E[lambda] = a/b = 1 at the defaults)."""
    full = lambda v: jnp.full((K, D), v, dtype)
    return GammaP(a=full(a), b=full(b))


def expected_log_likelihood(q: GammaP, y: jax.Array) -> jax.Array:
    """E_q[log Poisson(y | lambda_k)]: y (..., D) -> (..., K). Includes the
    exact -sum_d log y_d! normalizer (k-independent: free for FB, needed
    for log_z / ELBO / predictive comparisons)."""
    e_log_lam = digamma(q.a) - jnp.log(q.b)  # (K, D)
    e_lam = q.a / q.b
    lin = jnp.einsum("...d,kd->...k", y, e_log_lam)
    const = -jnp.sum(e_lam, axis=-1)  # (K,)
    norm = -jnp.sum(gammaln(y + 1.0), axis=-1)  # (...,)
    return lin + const + norm[..., None]


def ell_features(y: jax.Array) -> jax.Array:
    """(..., D) -> (..., 2+D) features [1, y, sum_d log y_d!].

    ``expected_log_likelihood(q, y) == ell_features(y) @ ell_feature_matrix(q)``
    and the same array's [1, y] columns are the sufficient-stat side of a
    flat gamma^T @ feats stat contraction."""
    ones = jnp.ones(y.shape[:-1] + (1,), y.dtype)
    lgy = jnp.sum(gammaln(y + 1.0), axis=-1, keepdims=True)
    return jnp.concatenate([ones, y, lgy], axis=-1)


def ell_feature_matrix(q: GammaP) -> jax.Array:
    """(2+D, K) weights W: rows [ -sum E[lambda]; E[log lambda] (D); -1 ]."""
    e_log_lam = digamma(q.a) - jnp.log(q.b)  # (K, D)
    const = -jnp.sum(q.a / q.b, axis=-1)  # (K,)
    neg1 = -jnp.ones((1, q.a.shape[0]), q.a.dtype)
    return jnp.concatenate([const[None, :], jnp.swapaxes(e_log_lam, 0, 1), neg1], axis=0)


def suff_stats(gamma: jax.Array, y: jax.Array) -> PoissonStats:
    """gamma (..., T, K), y (..., T, D) -> stats with leading (..., K)."""
    n = jnp.sum(gamma, axis=-2)
    sum_y = jnp.einsum("...tk,...td->...kd", gamma, y)
    return PoissonStats(n=n, sum_y=sum_y)


def posterior(prior: GammaP, stats: PoissonStats) -> GammaP:
    """Exact conjugate mean-field update."""
    return GammaP(a=prior.a + stats.sum_y, b=prior.b + stats.n[..., None])


def nat_grad_step(q: GammaP, prior: GammaP, stats: PoissonStats,
                  scale: jax.Array | float, rho: jax.Array | float) -> GammaP:
    """SVI natural-gradient step. The Gamma natural params (a - 1, -b) are
    affine in (a, b), so blending (a, b) directly IS the natural-parameter
    blend; rho=1, scale=1 with full-data stats equals :func:`posterior`."""
    return GammaP(
        a=(1.0 - rho) * q.a + rho * (prior.a + scale * stats.sum_y),
        b=(1.0 - rho) * q.b + rho * (prior.b + scale * stats.n[..., None]),
    )


def kl(q: GammaP, p: GammaP) -> jax.Array:
    """KL(Gamma_q || Gamma_p) per leading element, summed over D."""
    val = (
        (q.a - p.a) * digamma(q.a)
        - gammaln(q.a)
        + gammaln(p.a)
        + p.a * (jnp.log(q.b) - jnp.log(p.b))
        + q.a * (p.b - q.b) / q.b
    )
    return jnp.sum(val, axis=-1)


def mean_params(q: GammaP) -> jax.Array:
    """Posterior-mean rates E[lambda] = a / b for plug-in scoring."""
    return q.a / q.b


def poisson_log_likelihood(lam: jax.Array, y: jax.Array) -> jax.Array:
    """log Poisson(y_t | lambda_k): y (..., D), lam (K, D) -> (..., K)."""
    lin = jnp.einsum("...d,kd->...k", y, jnp.log(lam))
    return (
        lin
        - jnp.sum(lam, axis=-1)
        - jnp.sum(gammaln(y + 1.0), axis=-1)[..., None]
    )


def predictive_log_likelihood(q: GammaP, y: jax.Array) -> jax.Array:
    """Exact Gamma-Poisson posterior predictive: per-dim negative binomial
    NB(r = a, p = b / (b + 1)), product over dims. y (..., D) -> (..., K)."""
    yk = y[..., None, :]  # (..., 1, D) vs (K, D)
    return jnp.sum(
        gammaln(yk + q.a)
        - gammaln(q.a)
        - gammaln(yk + 1.0)
        + q.a * (jnp.log(q.b) - jnp.log1p(q.b))
        - yk * jnp.log1p(q.b),
        axis=-1,
    )


def sample_params(key: jax.Array, q: GammaP) -> jax.Array:
    """Draw lambda ~ Gamma(a, b) per leading element (Gibbs engines)."""
    return jax.random.gamma(key, q.a, dtype=q.a.dtype) / q.b
