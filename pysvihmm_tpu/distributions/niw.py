"""Normal-Inverse-Wishart (NIW) conjugate prior for Gaussian emissions.

Replacement for ``pybasicbayes.distributions.Gaussian`` as used by
``pysvihmm`` (reconstructed — SURVEY.md §2.2): ``expected_log_likelihood``,
``meanfieldupdate`` (= :func:`posterior`), ``meanfield_sgdstep``
(= :func:`nat_grad_step`), ``get_vlb`` (= :func:`kl`).

Parameters are a pytree batched over arbitrary leading axes (canonically the
K hidden states): mean (..., D), kappa (...), nu (...), psi (..., D, D).

Design notes:
  * The expensive per-observation quantity E_q[log N(y | mu, Sigma)] is
    evaluated through precomputed per-state quadratic-form parameters
    (P = nu * psi^{-1}, h = P m, const) so the T x K likelihood matrix is a
    single (T, D) @ (D, K*D) matmul + reduction — no per-t loop.
  * Natural-gradient steps are linear blends in the natural parameterization
    (eta1 = kappa*m, eta2 = kappa, eta3 = psi + kappa m m^T, eta4 = nu), which
    makes the SVI update a fused elementwise op.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln


class NIW(NamedTuple):
    """NIW parameters, leading axes broadcast (canonically (K,))."""

    mean: jax.Array  # (..., D)
    kappa: jax.Array  # (...,)
    nu: jax.Array  # (...,)
    psi: jax.Array  # (..., D, D)


class GaussianStats(NamedTuple):
    """Weighted Gaussian sufficient statistics sum_t w_t * (1, y, y y^T)."""

    n: jax.Array  # (...,)
    sum_y: jax.Array  # (..., D)
    sum_yyT: jax.Array  # (..., D, D)


def make_prior(
    K: int,
    D: int,
    *,
    mean: jax.Array | None = None,
    kappa: float = 1.0,
    nu: float | None = None,
    psi_scale: float = 1.0,
    dtype=jnp.float32,
) -> NIW:
    """Weakly-informative NIW prior replicated over K states."""
    if mean is None:
        mean = jnp.zeros((D,), dtype)
    mean = jnp.broadcast_to(jnp.asarray(mean, dtype), (K, D))
    if nu is None:
        nu = D + 2.0
    return NIW(
        mean=mean,
        kappa=jnp.full((K,), kappa, dtype),
        nu=jnp.full((K,), nu, dtype),
        psi=jnp.broadcast_to(jnp.eye(D, dtype=dtype) * psi_scale, (K, D, D)),
    )


def _mvdigamma_half(nu: jax.Array, D: int) -> jax.Array:
    """sum_{i=1..D} digamma((nu + 1 - i) / 2), batched over nu's axes."""
    i = jnp.arange(1, D + 1, dtype=nu.dtype)
    return jnp.sum(digamma((nu[..., None] + 1.0 - i) / 2.0), axis=-1)


def _mv_gammaln(a: jax.Array, D: int) -> jax.Array:
    """log multivariate gamma: Gamma_D(a)."""
    i = jnp.arange(1, D + 1, dtype=a.dtype)
    return D * (D - 1) / 4.0 * jnp.log(jnp.pi) + jnp.sum(
        gammaln(a[..., None] + (1.0 - i) / 2.0), axis=-1
    )


def _logdet_psd(m: jax.Array) -> jax.Array:
    chol = jnp.linalg.cholesky(m)
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)


def expected_logdet_precision(q: NIW) -> jax.Array:
    """E_q[log |Sigma^{-1}|] = mvdigamma(nu/2) + D log 2 - log|Psi|."""
    D = q.mean.shape[-1]
    return _mvdigamma_half(q.nu, D) + D * jnp.log(2.0) - _logdet_psd(q.psi)


class EllParams(NamedTuple):
    """Precomputed parameters of the expected-log-likelihood quadratic form.

    E_q[log N(y|mu, Sigma)] = const - 0.5 * y^T P y + y . h   with
    P = nu * Psi^{-1}, h = P m,
    const = 0.5*(E[log|Lambda|] - D log 2pi - D/kappa) - 0.5 m^T P m.
    """

    P: jax.Array  # (..., D, D)
    h: jax.Array  # (..., D)
    const: jax.Array  # (...,)


def ell_params(q: NIW) -> EllParams:
    D = q.mean.shape[-1]
    eye = jnp.eye(D, dtype=q.psi.dtype)
    chol = jnp.linalg.cholesky(q.psi)
    psi_inv = jax.scipy.linalg.cho_solve((chol, True), jnp.broadcast_to(eye, q.psi.shape))
    P = q.nu[..., None, None] * psi_inv
    h = jnp.einsum("...de,...e->...d", P, q.mean)
    elogdet = _mvdigamma_half(q.nu, D) + D * jnp.log(2.0) - 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1
    )
    const = 0.5 * (
        elogdet - D * jnp.log(2.0 * jnp.pi) - D / q.kappa
    ) - 0.5 * jnp.einsum("...d,...d->...", q.mean, h)
    return EllParams(P=P, h=h, const=const)


def expected_log_likelihood(q: NIW, y: jax.Array) -> jax.Array:
    """E_q[log N(y_t | mu_k, Sigma_k)] for y (..., D) and q leading (K,).

    Returns (..., K). The quadratic term is evaluated as
    0.5 * sum_d (y @ P_k)_d * y_d via one batched matmul.
    """
    p = ell_params(q)
    D = y.shape[-1]
    # Quadratic form via y (x) y features: a (..., D^2) @ (D^2, K) matmul.
    # The naive "...d,kde->...ke" einsum materializes a (..., K, D)
    # intermediate — K/D times the data — which at B*T=1M costs more memory
    # traffic than the entire forward-backward; the feature matmul keeps
    # the intermediate at D^2 floats/obs.
    yy = _pair_features(y)
    quad = jnp.einsum("...f,kf->...k", yy, p.P.reshape(p.P.shape[0], D * D))
    lin = jnp.einsum("...d,kd->...k", y, p.h)
    return p.const - 0.5 * quad + lin


def ell_features(y: jax.Array) -> jax.Array:
    """(..., D) -> (..., 1 + D + D(D+1)/2) features [1, y, triu(y (x) y)].

    ``expected_log_likelihood(q, y) == ell_features(y) @ ell_feature_matrix(q)``
    and the SAME array is the per-observation feature side of the Gaussian
    sufficient-statistics matmul — computing it once halves the dominant
    per-observation memory traffic of the E-step's emission work.

    The quadratic block keeps only the UPPER TRIANGLE (with diagonal) of
    y (x) y in row-major (i, j >= i) order: y y^T is symmetric, so the
    full D^2 block spent 44% of the feature width (64 vs 36 at D=8) on
    duplicate columns — pure extra matmul width. The off-diagonal 2x
    lives in the WEIGHTS
    (:func:`ell_feature_matrix`), so the stat columns stay the raw sums
    sum w gamma y_i y_j that :meth:`unpack_flat_stats` mirrors back to
    the full symmetric matrix.
    """
    ones = jnp.ones(y.shape[:-1] + (1,), y.dtype)
    return jnp.concatenate([ones, y, _triu_features(y)], axis=-1)


def ell_feature_matrix(q: NIW) -> jax.Array:
    """(1 + D + D(D+1)/2, K) weights W with
    E_q[log N(y | mu_k, Sigma_k)] = feats @ W (triu feature layout: the
    off-diagonal P entries carry the symmetric 2x)."""
    p = ell_params(q)
    K, D = q.mean.shape
    iu, ju = jnp.triu_indices(D)
    scale = jnp.where(iu == ju, 1.0, 2.0)
    pair_w = -0.5 * p.P[:, iu, ju] * scale  # (K, D(D+1)/2)
    return jnp.concatenate(
        [
            p.const[None, :],
            jnp.swapaxes(p.h, 0, 1),
            jnp.swapaxes(pair_w, 0, 1),
        ],
        axis=0,
    )


def _triu_features(y: jax.Array) -> jax.Array:
    """(..., D) -> (..., D(D+1)/2) products y_i y_j for i <= j, row-major.

    Concatenation of D shrinking broadcast-multiplies — never through a
    (..., D, D) intermediate (see :func:`_pair_features`).
    PYSVIHMM_GATHER_FEATS (measurement knob): one multiply of two
    gathered (..., P) arrays instead of the D-piece concat."""
    import os

    D = y.shape[-1]
    if os.environ.get("PYSVIHMM_GATHER_FEATS"):
        iu, ju = jnp.triu_indices(D)
        return jnp.take(y, iu, axis=-1) * jnp.take(y, ju, axis=-1)
    return jnp.concatenate(
        [y[..., d : d + 1] * y[..., d:] for d in range(D)], axis=-1
    )


def _pair_features(y: jax.Array) -> jax.Array:
    """(..., D) -> (..., D*D) pairwise products y_d * y_e, f = d*D + e.

    Built by concatenation of D broadcast-multiplies — never through a
    (..., D, D) intermediate, whose tiny trailing dims lay out poorly.
    """
    D = y.shape[-1]
    return jnp.concatenate([y[..., d : d + 1] * y for d in range(D)], axis=-1)


def suff_stats(gamma: jax.Array, y: jax.Array) -> GaussianStats:
    """Expected sufficient stats weighted by state responsibilities.

    gamma: (..., T, K) weights; y: (..., T, D). Returns stats with leading
    (..., K). yy^T contraction is a (K, T) @ (T, D*D) matmul.
    """
    n = jnp.sum(gamma, axis=-2)
    sum_y = jnp.einsum("...tk,...td->...kd", gamma, y)
    # (K, T) @ (T, D^2) matmul over y (x) y features — the triple
    # einsum's (T, K, D) / (T, D, D) intermediates are K/D times the data
    D = y.shape[-1]
    sum_yyT = jnp.einsum("...tk,...tf->...kf", gamma, _pair_features(y)).reshape(
        *n.shape, D, D
    )
    return GaussianStats(n=n, sum_y=sum_y, sum_yyT=sum_yyT)


def posterior(prior: NIW, stats: GaussianStats) -> NIW:
    """Exact conjugate mean-field update (pybasicbayes ``meanfieldupdate``)."""
    kappa_n = prior.kappa + stats.n
    nu_n = prior.nu + stats.n
    mean_n = (prior.kappa[..., None] * prior.mean + stats.sum_y) / kappa_n[..., None]
    psi_n = (
        prior.psi
        + stats.sum_yyT
        + prior.kappa[..., None, None]
        * jnp.einsum("...d,...e->...de", prior.mean, prior.mean)
        - kappa_n[..., None, None] * jnp.einsum("...d,...e->...de", mean_n, mean_n)
    )
    return NIW(mean=mean_n, kappa=kappa_n, nu=nu_n, psi=psi_n)


class NIWNat(NamedTuple):
    eta1: jax.Array  # kappa * m              (..., D)
    eta2: jax.Array  # kappa                  (...,)
    eta3: jax.Array  # psi + kappa m m^T      (..., D, D)
    eta4: jax.Array  # nu                     (...,)


def to_natural(q: NIW) -> NIWNat:
    return NIWNat(
        eta1=q.kappa[..., None] * q.mean,
        eta2=q.kappa,
        eta3=q.psi + q.kappa[..., None, None]
        * jnp.einsum("...d,...e->...de", q.mean, q.mean),
        eta4=q.nu,
    )


def from_natural(n: NIWNat) -> NIW:
    mean = n.eta1 / n.eta2[..., None]
    return NIW(
        mean=mean,
        kappa=n.eta2,
        nu=n.eta4,
        psi=n.eta3 - n.eta2[..., None, None]
        * jnp.einsum("...d,...e->...de", mean, mean),
    )


def nat_grad_step(
    q: NIW,
    prior: NIW,
    stats: GaussianStats,
    scale: jax.Array | float,
    rho: jax.Array | float,
) -> NIW:
    """SVI natural-gradient step (pybasicbayes ``meanfield_sgdstep``).

    eta <- (1-rho) eta + rho (eta_prior + scale * t(stats)), where the
    sufficient-statistic map is t = (sum_y, n, sum_yyT, n). With rho=1,
    scale=1 and full-data stats this equals :func:`posterior` exactly
    (property-tested in tests/test_distributions.py).
    """
    qn, pn = to_natural(q), to_natural(prior)
    blended = NIWNat(
        eta1=(1.0 - rho) * qn.eta1 + rho * (pn.eta1 + scale * stats.sum_y),
        eta2=(1.0 - rho) * qn.eta2 + rho * (pn.eta2 + scale * stats.n),
        eta3=(1.0 - rho) * qn.eta3 + rho * (pn.eta3 + scale * stats.sum_yyT),
        eta4=(1.0 - rho) * qn.eta4 + rho * (pn.eta4 + scale * stats.n),
    )
    return from_natural(blended)


def kl(q: NIW, p: NIW) -> jax.Array:
    """KL(NIW_q || NIW_p) per leading element.

    Decomposed as E_q(Lambda)[KL(N(m_q,(kappa_q Lambda)^-1) || N(m_p, ...))]
    + KL(Wishart_q || Wishart_p) on the precision (V = Psi^{-1}).
    """
    D = q.mean.shape[-1]
    elogdet = expected_logdet_precision(q)
    chol_q = jnp.linalg.cholesky(q.psi)
    # tr(Psi_p Psi_q^{-1})
    psi_q_inv_psi_p = jax.scipy.linalg.cho_solve((chol_q, True), p.psi)
    tr_term = jnp.trace(psi_q_inv_psi_p, axis1=-2, axis2=-1)
    logdet_q = _logdet_psd(q.psi)
    logdet_p = _logdet_psd(p.psi)

    kl_wishart = (
        0.5 * (q.nu - p.nu) * elogdet
        - 0.5 * q.nu * D
        + 0.5 * q.nu * tr_term
        - 0.5 * (q.nu - p.nu) * D * jnp.log(2.0)
        + 0.5 * q.nu * logdet_q
        - 0.5 * p.nu * logdet_p
        + _mv_gammaln(p.nu / 2.0, D)
        - _mv_gammaln(q.nu / 2.0, D)
    )

    dm = q.mean - p.mean
    # E_q[Lambda] = nu_q Psi_q^{-1}; quad = dm^T E[Lambda] dm
    sol = jax.scipy.linalg.cho_solve((chol_q, True), dm[..., None])[..., 0]
    quad = q.nu * jnp.einsum("...d,...d->...", dm, sol)
    ratio = p.kappa / q.kappa
    kl_normal = 0.5 * (p.kappa * quad + D * (ratio - 1.0 - jnp.log(ratio)))
    return kl_wishart + kl_normal


def mean_params(q: NIW) -> tuple[jax.Array, jax.Array]:
    """Posterior-mean point estimate (E[mu], E[Sigma]) for plug-in scoring."""
    D = q.mean.shape[-1]
    denom = jnp.maximum(q.nu - D - 1.0, 1e-2)
    return q.mean, q.psi / denom[..., None, None]


def sample_params(key: jax.Array, q: NIW) -> tuple[jax.Array, jax.Array]:
    """Draw (mu, Sigma) ~ NIW(q) for each leading element (Gibbs engines).

    Sigma^{-1} ~ Wishart(Psi^{-1}, nu) via Bartlett decomposition;
    mu | Sigma ~ N(m, Sigma / kappa).
    """
    D = q.mean.shape[-1]
    batch = q.kappa.shape
    k_chi, k_norm, k_mu = jax.random.split(key, 3)

    # Bartlett: A lower-triangular, A_ii^2 ~ chi2(nu - i + 1), A_ij ~ N(0,1).
    i = jnp.arange(D, dtype=q.nu.dtype)
    df = q.nu[..., None] - i  # (..., D), df_i = nu - i (i starting 0) = nu - (i+1) + 1
    chi2 = 2.0 * jax.random.gamma(k_chi, df / 2.0, shape=batch + (D,), dtype=q.nu.dtype)
    diag = jnp.sqrt(chi2)
    normals = jax.random.normal(k_norm, batch + (D, D), dtype=q.mean.dtype)
    eye_d = jnp.eye(D, dtype=q.mean.dtype)
    A = jnp.tril(normals, -1) + eye_d * diag[..., :, None]

    # V = Psi^{-1} = C C^T with C = chol(Psi)^{-T}: Lambda = (C A)(C A)^T.
    chol_psi = jnp.linalg.cholesky(q.psi)
    eye = jnp.broadcast_to(jnp.eye(D, dtype=q.psi.dtype), q.psi.shape)
    C = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol_psi, -1, -2), eye, lower=False
    )
    CA = C @ A
    lam = CA @ jnp.swapaxes(CA, -1, -2)
    sigma = jnp.linalg.inv(lam)
    sigma = 0.5 * (sigma + jnp.swapaxes(sigma, -1, -2))

    chol_sigma = jnp.linalg.cholesky(sigma)
    eps = jax.random.normal(k_mu, q.mean.shape, dtype=q.mean.dtype)
    mu = q.mean + jnp.einsum("...de,...e->...d", chol_sigma, eps) / jnp.sqrt(
        q.kappa
    )[..., None]
    return mu, sigma


def predictive_log_likelihood(q: NIW, y: jax.Array) -> jax.Array:
    """Exact NIW posterior-predictive: y ~ multivariate Student-t.

    y | q ~ t_{nu'}(m, Psi (kappa+1) / (kappa nu')) with nu' = nu - D + 1
    (Murphy, "Conjugate Bayesian analysis of the Gaussian", eq. 232).
    y (..., D), q leading (K,) -> (..., K). The plug-in-mean alternative is
    :func:`mean_params` + :func:`gaussian_log_likelihood` (reference
    behavior [MED]); this exact form integrates out (mu, Sigma).
    """
    D = q.mean.shape[-1]
    nu_p = q.nu - D + 1.0  # (K,)
    scale_fac = (q.kappa + 1.0) / (q.kappa * nu_p)  # (K,)
    S = q.psi * scale_fac[..., None, None]  # (K, D, D)
    chol = jnp.linalg.cholesky(S)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    eye = jnp.broadcast_to(jnp.eye(D, dtype=S.dtype), S.shape)
    prec = jax.scipy.linalg.cho_solve((chol, True), eye)
    diff = y[..., None, :] - q.mean  # (..., K, D)
    quad = jnp.einsum("...kd,kde,...ke->...k", diff, prec, diff)
    return (
        gammaln((nu_p + D) / 2.0)
        - gammaln(nu_p / 2.0)
        - 0.5 * D * jnp.log(nu_p * jnp.pi)
        - 0.5 * logdet
        - 0.5 * (nu_p + D) * jnp.log1p(quad / nu_p)
    )


def gaussian_log_likelihood(mu: jax.Array, sigma: jax.Array, y: jax.Array) -> jax.Array:
    """log N(y_t | mu_k, Sigma_k): y (..., D), mu (K, D) -> (..., K)."""
    D = mu.shape[-1]
    chol = jnp.linalg.cholesky(sigma)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    eye = jnp.broadcast_to(jnp.eye(D, dtype=sigma.dtype), sigma.shape)
    prec = jax.scipy.linalg.cho_solve((chol, True), eye)  # (K, D, D)
    diff = y[..., None, :] - mu  # (..., K, D)
    quad = jnp.einsum("...kd,kde,...ke->...k", diff, prec, diff)
    return -0.5 * (D * jnp.log(2.0 * jnp.pi) + logdet + quad)
