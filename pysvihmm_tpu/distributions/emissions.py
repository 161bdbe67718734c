"""Emission-family modules with a uniform static interface.

The reference delegates emissions to ``pybasicbayes`` distribution objects
held in ``var_emit`` lists (``pysvihmm/hmmbase.py``, reconstructed —
SURVEY.md §2.2). Here each family is a stateless namespace of pure functions
over pytree parameters so engines can be written once, generically, and the
family chosen statically at jit time.

Families:
  * :class:`GaussianNIW` — Gaussian emissions under a Normal-Inverse-Wishart
    prior (reference: ``pybasicbayes`` ``Gaussian``).
  * :class:`DiagonalGaussianNIG` — diagonal-covariance Gaussian emissions
    under per-dimension Normal-Inverse-Gamma priors (reference:
    ``pybasicbayes`` ``DiagonalGaussian``).
  * :class:`MultinomialDirichlet` — categorical emissions over V symbols
    under a Dirichlet prior (reference: ``pybasicbayes`` ``Multinomial``).
  * :class:`PoissonGamma` — per-dimension Poisson counts under conjugate
    Gamma priors (extension beyond the reference's family list).

Families exposing ``ell_features`` / ``ell_feature_matrix`` /
``unpack_flat_stats`` have a feature form: the expected log-likelihood is
feats @ W and the emission sufficient statistics are one gamma^T @ feats
matmul unpacked per family.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from . import diag_gaussian, dirichlet, niw, poisson
from .diag_gaussian import NIG, DiagGaussianStats
from .niw import NIW, GaussianStats
from .poisson import GammaP, PoissonStats


class GaussianNIW:
    """Gaussian emission family with conjugate NIW prior. Params: :class:`NIW` (K,...)."""

    name = "gaussian_niw"

    @staticmethod
    def make_prior(K: int, obs_dim: int, dtype=jnp.float32, **kw) -> NIW:
        return niw.make_prior(K, obs_dim, dtype=dtype, **kw)

    @staticmethod
    def expected_log_likelihood(params: NIW, y: jax.Array) -> jax.Array:
        """y (..., D) -> (..., K)."""
        return niw.expected_log_likelihood(params, y)

    @staticmethod
    def ell_features(y: jax.Array) -> jax.Array:
        """Shared per-observation features [1, y, y (x) y] (see niw.ell_features)."""
        return niw.ell_features(y)

    @staticmethod
    def ell_feature_matrix(params: NIW) -> jax.Array:
        return niw.ell_feature_matrix(params)

    @staticmethod
    def suff_stats(gamma: jax.Array, y: jax.Array) -> GaussianStats:
        return niw.suff_stats(gamma, y)

    @staticmethod
    def zero_stats(params: NIW) -> GaussianStats:
        K, D = params.mean.shape[-2], params.mean.shape[-1]
        z = jnp.zeros
        dt = params.mean.dtype
        return GaussianStats(n=z((K,), dt), sum_y=z((K, D), dt), sum_yyT=z((K, D, D), dt))

    @staticmethod
    def posterior(prior: NIW, stats: GaussianStats) -> NIW:
        return niw.posterior(prior, stats)

    @staticmethod
    def nat_grad_step(q: NIW, prior: NIW, stats: GaussianStats, scale, rho) -> NIW:
        return niw.nat_grad_step(q, prior, stats, scale, rho)

    @staticmethod
    def kl(q: NIW, p: NIW) -> jax.Array:
        return jnp.sum(niw.kl(q, p))

    @staticmethod
    def mean_params(q: NIW):
        return niw.mean_params(q)

    @staticmethod
    def point_log_likelihood(theta, y: jax.Array) -> jax.Array:
        """theta = (mu (K,D), sigma (K,D,D)); y (..., D) -> (..., K)."""
        mu, sigma = theta
        return niw.gaussian_log_likelihood(mu, sigma, y)

    @staticmethod
    def predictive_log_likelihood(params: NIW, y: jax.Array) -> jax.Array:
        """Exact posterior-predictive (Student-t, integrates out mu/Sigma)."""
        return niw.predictive_log_likelihood(params, y)

    @staticmethod
    def sample_params(key: jax.Array, q: NIW):
        return niw.sample_params(key, q)

    @staticmethod
    def sample_obs(key: jax.Array, theta, z: jax.Array) -> jax.Array:
        """Sample y_t | z_t for an int state path z (...,)."""
        mu, sigma = theta
        chol = jnp.linalg.cholesky(sigma)
        eps = jax.random.normal(key, z.shape + (mu.shape[-1],), dtype=mu.dtype)
        return mu[z] + jnp.einsum("...de,...e->...d", chol[z], eps)

    @staticmethod
    def unpack_flat_stats(params: NIW, S: jax.Array) -> GaussianStats:
        """(K, 1 + D + D(D+1)/2) flat gamma^T @ feats accumulator -> GaussianStats.

        The triu stat columns are the raw sums sum w gamma y_i y_j for
        i <= j (niw.ell_features layout); mirror them back to the full
        symmetric (K, D, D) second-moment matrix."""
        import numpy as _np

        D = params.mean.shape[-1]
        K = S.shape[0]
        iu, ju = _np.triu_indices(D)
        upper = jnp.zeros((K, D, D), S.dtype).at[:, iu, ju].set(S[:, 1 + D :])
        eye = jnp.eye(D, dtype=S.dtype)
        sum_yyT = upper + jnp.swapaxes(upper, -1, -2) * (1.0 - eye)
        return GaussianStats(n=S[:, 0], sum_y=S[:, 1 : 1 + D], sum_yyT=sum_yyT)


class DiagonalGaussianNIG:
    """Diagonal-Gaussian emissions, per-dim NIG prior. Params: :class:`NIG` (K, D)."""

    name = "diag_gaussian_nig"

    @staticmethod
    def make_prior(K: int, obs_dim: int, dtype=jnp.float32, **kw) -> NIG:
        return diag_gaussian.make_prior(K, obs_dim, dtype=dtype, **kw)

    @staticmethod
    def expected_log_likelihood(params: NIG, y: jax.Array) -> jax.Array:
        """y (..., D) -> (..., K)."""
        return diag_gaussian.expected_log_likelihood(params, y)

    @staticmethod
    def ell_features(y: jax.Array) -> jax.Array:
        """Shared per-observation features [1, y, y^2] (width 1+2D)."""
        return diag_gaussian.ell_features(y)

    @staticmethod
    def ell_feature_matrix(params: NIG) -> jax.Array:
        return diag_gaussian.ell_feature_matrix(params)

    @staticmethod
    def suff_stats(gamma: jax.Array, y: jax.Array) -> DiagGaussianStats:
        return diag_gaussian.suff_stats(gamma, y)

    @staticmethod
    def zero_stats(params: NIG) -> DiagGaussianStats:
        K, D = params.mean.shape[-2], params.mean.shape[-1]
        z, dt = jnp.zeros, params.mean.dtype
        return DiagGaussianStats(n=z((K,), dt), sum_y=z((K, D), dt), sum_y2=z((K, D), dt))

    @staticmethod
    def posterior(prior: NIG, stats: DiagGaussianStats) -> NIG:
        return diag_gaussian.posterior(prior, stats)

    @staticmethod
    def nat_grad_step(q: NIG, prior: NIG, stats: DiagGaussianStats, scale, rho) -> NIG:
        return diag_gaussian.nat_grad_step(q, prior, stats, scale, rho)

    @staticmethod
    def kl(q: NIG, p: NIG) -> jax.Array:
        return jnp.sum(diag_gaussian.kl(q, p))

    @staticmethod
    def mean_params(q: NIG):
        return diag_gaussian.mean_params(q)

    @staticmethod
    def point_log_likelihood(theta, y: jax.Array) -> jax.Array:
        """theta = (mu (K,D), sigma2 (K,D)); y (..., D) -> (..., K)."""
        mu, sigma2 = theta
        return diag_gaussian.diag_gaussian_log_likelihood(mu, sigma2, y)

    @staticmethod
    def predictive_log_likelihood(params: NIG, y: jax.Array) -> jax.Array:
        """Exact posterior-predictive (per-dim Student-t product)."""
        return diag_gaussian.predictive_log_likelihood(params, y)

    @staticmethod
    def sample_params(key: jax.Array, q: NIG):
        return diag_gaussian.sample_params(key, q)

    @staticmethod
    def sample_obs(key: jax.Array, theta, z: jax.Array) -> jax.Array:
        """Sample y_t | z_t for an int state path z (...,)."""
        mu, sigma2 = theta
        eps = jax.random.normal(key, z.shape + (mu.shape[-1],), dtype=mu.dtype)
        return mu[z] + jnp.sqrt(sigma2[z]) * eps

    @staticmethod
    def unpack_flat_stats(params: NIG, S: jax.Array) -> DiagGaussianStats:
        """(K, 1+2D) flat gamma^T @ feats accumulator -> DiagGaussianStats."""
        D = params.mean.shape[-1]
        return DiagGaussianStats(
            n=S[:, 0], sum_y=S[:, 1 : 1 + D], sum_y2=S[:, 1 + D :]
        )


class MultinomialDirichlet:
    """Categorical emissions over V symbols, Dirichlet prior. Params: (K, V) array."""

    name = "multinomial_dirichlet"

    @staticmethod
    def make_prior(K: int, num_symbols: int, alpha: float = 0.5, dtype=jnp.float32):
        return jnp.full((K, num_symbols), alpha, dtype)

    @staticmethod
    def expected_log_likelihood(params: jax.Array, y: jax.Array) -> jax.Array:
        """y int (...,) -> (..., K) by gathering E[log phi_{k, y_t}]."""
        elp = dirichlet.expected_log_probs(params)  # (K, V)
        return jnp.moveaxis(elp[:, y], 0, -1)

    @staticmethod
    def make_suff_stats(num_symbols: int):
        def stats(gamma: jax.Array, y: jax.Array) -> jax.Array:
            onehot = jax.nn.one_hot(y, num_symbols, dtype=gamma.dtype)
            return jnp.einsum("...tk,...tv->...kv", gamma, onehot)

        return stats

    @staticmethod
    def zero_stats(params: jax.Array) -> jax.Array:
        return jnp.zeros_like(params)

    @staticmethod
    def posterior(prior: jax.Array, stats: jax.Array) -> jax.Array:
        return dirichlet.posterior(prior, stats)

    @staticmethod
    def nat_grad_step(q, prior, stats, scale, rho):
        return dirichlet.nat_grad_step(q, prior, stats, scale, rho)

    @staticmethod
    def kl(q: jax.Array, p: jax.Array) -> jax.Array:
        return jnp.sum(dirichlet.kl(q, p))

    @staticmethod
    def mean_params(q: jax.Array) -> jax.Array:
        return dirichlet.mean(q)

    @staticmethod
    def point_log_likelihood(theta: jax.Array, y: jax.Array) -> jax.Array:
        """theta = phi (K, V) simplex rows; y int (...,) -> (..., K)."""
        logp = jnp.log(theta)
        return jnp.moveaxis(logp[:, y], 0, -1)

    @staticmethod
    def predictive_log_likelihood(params: jax.Array, y: jax.Array) -> jax.Array:
        """Exact single-symbol Dirichlet-multinomial predictive = posterior
        mean probabilities (gathered at y)."""
        logp = jnp.log(dirichlet.mean(params))
        return jnp.moveaxis(logp[:, y], 0, -1)

    @staticmethod
    def sample_params(key: jax.Array, q: jax.Array) -> jax.Array:
        return jax.random.dirichlet(key, q)

    @staticmethod
    def sample_obs(key: jax.Array, theta: jax.Array, z: jax.Array) -> jax.Array:
        logits = jnp.log(theta)[z]  # (..., V)
        return jax.random.categorical(key, logits, axis=-1)

    @staticmethod
    def unpack_flat_stats(params: jax.Array, S: jax.Array) -> jax.Array:
        """(K, V) flat gamma^T @ one-hot accumulator IS the Dirichlet stats matrix."""
        return S


class PoissonGamma:
    """Poisson-count emissions, per-dim Gamma prior. Params: :class:`GammaP` (K, D)."""

    name = "poisson_gamma"

    @staticmethod
    def make_prior(K: int, obs_dim: int, dtype=jnp.float32, **kw) -> GammaP:
        return poisson.make_prior(K, obs_dim, dtype=dtype, **kw)

    @staticmethod
    def expected_log_likelihood(params: GammaP, y: jax.Array) -> jax.Array:
        """y (..., D) float counts -> (..., K)."""
        return poisson.expected_log_likelihood(params, y)

    @staticmethod
    def ell_features(y: jax.Array) -> jax.Array:
        """Shared per-observation features [1, y, sum log y!] (width 2+D)."""
        return poisson.ell_features(y)

    @staticmethod
    def ell_feature_matrix(params: GammaP) -> jax.Array:
        return poisson.ell_feature_matrix(params)

    @staticmethod
    def suff_stats(gamma: jax.Array, y: jax.Array) -> PoissonStats:
        return poisson.suff_stats(gamma, y)

    @staticmethod
    def zero_stats(params: GammaP) -> PoissonStats:
        K, D = params.a.shape[-2], params.a.shape[-1]
        z, dt = jnp.zeros, params.a.dtype
        return PoissonStats(n=z((K,), dt), sum_y=z((K, D), dt))

    @staticmethod
    def posterior(prior: GammaP, stats: PoissonStats) -> GammaP:
        return poisson.posterior(prior, stats)

    @staticmethod
    def nat_grad_step(q: GammaP, prior: GammaP, stats: PoissonStats, scale, rho) -> GammaP:
        return poisson.nat_grad_step(q, prior, stats, scale, rho)

    @staticmethod
    def kl(q: GammaP, p: GammaP) -> jax.Array:
        return jnp.sum(poisson.kl(q, p))

    @staticmethod
    def mean_params(q: GammaP) -> jax.Array:
        return poisson.mean_params(q)

    @staticmethod
    def point_log_likelihood(theta: jax.Array, y: jax.Array) -> jax.Array:
        """theta = lambda (K, D) rates; y (..., D) -> (..., K)."""
        return poisson.poisson_log_likelihood(theta, y)

    @staticmethod
    def predictive_log_likelihood(params: GammaP, y: jax.Array) -> jax.Array:
        """Exact posterior-predictive (per-dim negative binomial product)."""
        return poisson.predictive_log_likelihood(params, y)

    @staticmethod
    def sample_params(key: jax.Array, q: GammaP) -> jax.Array:
        return poisson.sample_params(key, q)

    @staticmethod
    def sample_obs(key: jax.Array, theta: jax.Array, z: jax.Array) -> jax.Array:
        """Sample y_t | z_t for an int state path z (...,); returns float32
        counts (the engines' observation dtype)."""
        return jax.random.poisson(key, theta[z]).astype(theta.dtype)

    @staticmethod
    def unpack_flat_stats(params: GammaP, S: jax.Array) -> PoissonStats:
        """(K, 2+D) flat gamma^T @ feats accumulator -> PoissonStats (the trailing
        log-factorial column is not a sufficient statistic; dropped)."""
        D = params.a.shape[-1]
        return PoissonStats(n=S[:, 0], sum_y=S[:, 1 : 1 + D])
