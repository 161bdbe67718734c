"""Diagonal-Gaussian emissions under per-dimension Normal-Inverse-Gamma priors.

Replacement for ``pybasicbayes.distributions.DiagonalGaussian``,
the diagonal-covariance sibling of the ``Gaussian`` class the reference's
``var_emit`` lists hold (``pysvihmm/hmmbase.py``, reconstructed — SURVEY.md
§2.2). Same four-method contract as :mod:`.niw`: ``expected_log_likelihood``,
``meanfieldupdate`` (= :func:`posterior`), ``meanfield_sgdstep``
(= :func:`nat_grad_step`), ``get_vlb`` (= :func:`kl`).

Model, independently per dimension d:
    sigma2_d ~ InvGamma(a_d, b_d);  mu_d | sigma2_d ~ N(m_d, sigma2_d / kappa_d)

Design notes:
  * Everything is elementwise over (..., D) — no Cholesky, no D x D tiles.
    The expected log-likelihood is linear in the per-observation features
    [1, y, y^2] (width 1 + 2D vs the full-covariance family's
    1 + D + D(D+1)/2), so both the likelihood matmul and the
    sufficient-statistics matmul shrink ~D/4x.
  * Natural-parameter coordinates (kappa m, kappa, 2b + kappa m^2, 2a) make
    the SVI update a fused elementwise blend, with the SAME sufficient-
    statistic map shape t = (sum_y, n, sum_y2, n) as the NIW family.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln


class NIG(NamedTuple):
    """Per-dimension Normal-Inverse-Gamma parameters, leading axes broadcast
    (canonically (K,)). All fields are (..., D) — kappa/a/b per dimension,
    mirroring pybasicbayes' per-dim ``nus_0 / alphas_0 / betas_0``."""

    mean: jax.Array  # (..., D)
    kappa: jax.Array  # (..., D)
    a: jax.Array  # (..., D) inverse-gamma shape
    b: jax.Array  # (..., D) inverse-gamma scale


class DiagGaussianStats(NamedTuple):
    """Weighted diagonal-Gaussian sufficient stats sum_t w_t * (1, y, y^2)."""

    n: jax.Array  # (...,)
    sum_y: jax.Array  # (..., D)
    sum_y2: jax.Array  # (..., D)


def make_prior(
    K: int,
    D: int,
    *,
    mean: jax.Array | None = None,
    kappa: float = 1.0,
    a: float = 2.0,
    b: float = 1.0,
    dtype=jnp.float32,
) -> NIG:
    """Weakly-informative NIG prior replicated over K states (E[sigma2] =
    b/(a-1) = 1 at the defaults, matching the NIW default's E[Sigma] = I)."""
    if mean is None:
        mean = jnp.zeros((D,), dtype)
    mean = jnp.broadcast_to(jnp.asarray(mean, dtype), (K, D))
    full = lambda v: jnp.full((K, D), v, dtype)
    return NIG(mean=mean, kappa=full(kappa), a=full(a), b=full(b))


class EllParams(NamedTuple):
    """E_q[log N(y | mu, diag sigma2)] = const + y . c1 + y^2 . c2 with
    c2 = -0.5 E[1/sigma2], c1 = E[1/sigma2] m,
    const = 0.5 sum_d (E[log 1/sigma2_d] - log 2pi - E[1/sigma2_d] m_d^2
                       - 1/kappa_d)."""

    c1: jax.Array  # (..., D)
    c2: jax.Array  # (..., D)
    const: jax.Array  # (...,)


def ell_params(q: NIG) -> EllParams:
    e_prec = q.a / q.b  # E[1/sigma2]
    e_log_prec = digamma(q.a) - jnp.log(q.b)  # E[log 1/sigma2]
    c2 = -0.5 * e_prec
    c1 = e_prec * q.mean
    const = 0.5 * jnp.sum(
        e_log_prec - jnp.log(2.0 * jnp.pi) - e_prec * q.mean**2 - 1.0 / q.kappa,
        axis=-1,
    )
    return EllParams(c1=c1, c2=c2, const=const)


def expected_log_likelihood(q: NIG, y: jax.Array) -> jax.Array:
    """E_q[log N(y_t | mu_k, diag sigma2_k)]: y (..., D), q leading (K,) ->
    (..., K). Two thin (.., D) @ (D, K) matmuls — no (.., K, D)
    intermediate."""
    p = ell_params(q)
    lin = jnp.einsum("...d,kd->...k", y, p.c1)
    quad = jnp.einsum("...d,kd->...k", y * y, p.c2)
    return p.const + lin + quad


def ell_features(y: jax.Array) -> jax.Array:
    """(..., D) -> (..., 1+2D) features [1, y, y^2].

    ``expected_log_likelihood(q, y) == ell_features(y) @ ell_feature_matrix(q)``
    and the SAME array is the feature side of the sufficient-statistics
    matmul (see niw.ell_features for why sharing it matters)."""
    ones = jnp.ones(y.shape[:-1] + (1,), y.dtype)
    return jnp.concatenate([ones, y, y * y], axis=-1)


def ell_feature_matrix(q: NIG) -> jax.Array:
    """(1+2D, K) weights W with E_q[log N(y | mu_k, .)] = feats @ W."""
    p = ell_params(q)
    return jnp.concatenate(
        [p.const[None, :], jnp.swapaxes(p.c1, 0, 1), jnp.swapaxes(p.c2, 0, 1)],
        axis=0,
    )


def suff_stats(gamma: jax.Array, y: jax.Array) -> DiagGaussianStats:
    """gamma (..., T, K), y (..., T, D) -> stats with leading (..., K)."""
    n = jnp.sum(gamma, axis=-2)
    sum_y = jnp.einsum("...tk,...td->...kd", gamma, y)
    sum_y2 = jnp.einsum("...tk,...td->...kd", gamma, y * y)
    return DiagGaussianStats(n=n, sum_y=sum_y, sum_y2=sum_y2)


def posterior(prior: NIG, stats: DiagGaussianStats) -> NIG:
    """Exact conjugate mean-field update (pybasicbayes ``meanfieldupdate``)."""
    n = stats.n[..., None]
    kappa_n = prior.kappa + n
    mean_n = (prior.kappa * prior.mean + stats.sum_y) / kappa_n
    a_n = prior.a + 0.5 * n
    b_n = prior.b + 0.5 * (
        stats.sum_y2 + prior.kappa * prior.mean**2 - kappa_n * mean_n**2
    )
    return NIG(mean=mean_n, kappa=kappa_n, a=a_n, b=b_n)


class NIGNat(NamedTuple):
    eta1: jax.Array  # kappa * m            (..., D)
    eta2: jax.Array  # kappa                (..., D)
    eta3: jax.Array  # 2b + kappa m^2       (..., D)
    eta4: jax.Array  # 2a                   (..., D)


def to_natural(q: NIG) -> NIGNat:
    return NIGNat(
        eta1=q.kappa * q.mean,
        eta2=q.kappa,
        eta3=2.0 * q.b + q.kappa * q.mean**2,
        eta4=2.0 * q.a,
    )


def from_natural(n: NIGNat) -> NIG:
    mean = n.eta1 / n.eta2
    return NIG(
        mean=mean,
        kappa=n.eta2,
        a=0.5 * n.eta4,
        b=0.5 * (n.eta3 - n.eta2 * mean**2),
    )


def nat_grad_step(
    q: NIG,
    prior: NIG,
    stats: DiagGaussianStats,
    scale: jax.Array | float,
    rho: jax.Array | float,
) -> NIG:
    """SVI natural-gradient step (pybasicbayes ``meanfield_sgdstep``):
    eta <- (1-rho) eta + rho (eta_prior + scale * t(stats)) with
    t = (sum_y, n, sum_y2, n). With rho=1, scale=1 and full-data stats this
    equals :func:`posterior` exactly (property-tested)."""
    qn, pn = to_natural(q), to_natural(prior)
    n = stats.n[..., None]
    blended = NIGNat(
        eta1=(1.0 - rho) * qn.eta1 + rho * (pn.eta1 + scale * stats.sum_y),
        eta2=(1.0 - rho) * qn.eta2 + rho * (pn.eta2 + scale * n),
        eta3=(1.0 - rho) * qn.eta3 + rho * (pn.eta3 + scale * stats.sum_y2),
        eta4=(1.0 - rho) * qn.eta4 + rho * (pn.eta4 + scale * n),
    )
    return from_natural(blended)


def kl(q: NIG, p: NIG) -> jax.Array:
    """KL(NIG_q || NIG_p) per leading element (summed over D).

    Per dimension, with precision lambda = 1/sigma2 ~ Gamma(a, b):
    KL = KL_Gamma(a_q,b_q || a_p,b_p)
       + E_q(lambda)[ KL(N(m_q, (kappa_q lambda)^-1) || N(m_p, (kappa_p lambda)^-1)) ].
    """
    kl_gamma = (
        (q.a - p.a) * digamma(q.a)
        - gammaln(q.a)
        + gammaln(p.a)
        + p.a * (jnp.log(q.b) - jnp.log(p.b))
        + q.a * (p.b - q.b) / q.b
    )
    ratio = p.kappa / q.kappa
    kl_normal = 0.5 * (
        ratio - 1.0 - jnp.log(ratio) + p.kappa * (q.a / q.b) * (q.mean - p.mean) ** 2
    )
    return jnp.sum(kl_gamma + kl_normal, axis=-1)


def mean_params(q: NIG) -> tuple[jax.Array, jax.Array]:
    """Posterior-mean point estimate (E[mu], E[sigma2]) for plug-in scoring."""
    return q.mean, q.b / jnp.maximum(q.a - 1.0, 1e-2)


def sample_params(key: jax.Array, q: NIG) -> tuple[jax.Array, jax.Array]:
    """Draw (mu, sigma2) ~ NIG(q) per leading element (Gibbs engines)."""
    k_gam, k_mu = jax.random.split(key)
    lam = jax.random.gamma(k_gam, q.a, dtype=q.a.dtype) / q.b  # precision
    sigma2 = 1.0 / lam
    mu = q.mean + jax.random.normal(k_mu, q.mean.shape, q.mean.dtype) * jnp.sqrt(
        sigma2 / q.kappa
    )
    return mu, sigma2


def predictive_log_likelihood(q: NIG, y: jax.Array) -> jax.Array:
    """Exact NIG posterior-predictive: per-dim Student-t, product over dims.

    y_d ~ t_{2a}(m, b (kappa+1) / (a kappa)) (Murphy, "Conjugate Bayesian
    analysis of the Gaussian", §4's 1-D case applied per dimension).
    y (..., D), q leading (K,) -> (..., K)."""
    nu = 2.0 * q.a  # (K, D)
    s2 = q.b * (q.kappa + 1.0) / (q.a * q.kappa)  # (K, D)
    diff2 = (y[..., None, :] - q.mean) ** 2  # (..., K, D)
    return jnp.sum(
        gammaln((nu + 1.0) / 2.0)
        - gammaln(nu / 2.0)
        - 0.5 * jnp.log(nu * jnp.pi * s2)
        - 0.5 * (nu + 1.0) * jnp.log1p(diff2 / (nu * s2)),
        axis=-1,
    )


def diag_gaussian_log_likelihood(
    mu: jax.Array, sigma2: jax.Array, y: jax.Array
) -> jax.Array:
    """log N(y_t | mu_k, diag sigma2_k): y (..., D), mu (K, D) -> (..., K)."""
    diff2 = (y[..., None, :] - mu) ** 2  # (..., K, D)
    return -0.5 * jnp.sum(
        jnp.log(2.0 * jnp.pi * sigma2) + diff2 / sigma2, axis=-1
    )
