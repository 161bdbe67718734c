"""Bayesian HMM model family: global variational state and shared helpers.

The reference holds this state mutably on ``VariationalHMMBase``
(``pysvihmm/hmmbase.py``, reconstructed — SURVEY.md §2.2: ``var_init``,
``var_tran``, ``var_emit``). Here it is an immutable pytree threaded through
pure `(state, batch) -> state` step functions, so every engine is jit/vmap/
shard_map-compatible by construction.

Generative model (K states; Foti et al. 2014 §2):
    pi ~ Dir(alpha_pi);  A_k. ~ Dir(alpha_A);  phi_k ~ NIW or Dir
    z_1 ~ pi;  z_{t+1} | z_t ~ A_{z_t .};  y_t | z_t ~ p(y | phi_{z_t})
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..distributions import dirichlet
from ..distributions.emissions import (
    DiagonalGaussianNIG,
    GaussianNIW,
    MultinomialDirichlet,
    PoissonGamma,
)
from ..utils.precision import f32_matmuls


# Canonical emission-family registry: the one string -> class mapping used
# by the compat layer, config system, and experiment scripts.
EMISSION_FAMILIES = {
    "gaussian": GaussianNIW,
    "diag_gaussian": DiagonalGaussianNIG,
    "multinomial": MultinomialDirichlet,
    "poisson": PoissonGamma,
}


def resolve_emission(name: str):
    """Emission family class for a config string; raises on unknown names."""
    try:
        return EMISSION_FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown emission family {name!r}; expected one of "
            f"{sorted(EMISSION_FAMILIES)}"
        ) from None


class HMMParams(NamedTuple):
    """Variational posterior q(pi) q(A) q(phi) — also used for the prior.

    init:  (K,)   Dirichlet concentrations for q(pi)
    trans: (K, K) Dirichlet concentrations, row k = q(A_k.)
    emit:  emission-family params, leading axis K (NIW pytree or (K, V))
    """

    init: jax.Array
    trans: jax.Array
    emit: Any


def make_prior(
    K: int,
    emission,
    *,
    obs_dim: int | None = None,
    num_symbols: int | None = None,
    alpha_init: float = 1.0,
    alpha_tran: float = 1.0,
    dtype=None,
    **emission_kw,
) -> HMMParams:
    # Default to the session float dtype (f32; f64 under jax_enable_x64) so
    # oracle-parity tests really exercise f64 end to end instead of silently
    # running the whole E-step in f32 params.
    if dtype is None:
        dtype = jax.dtypes.canonicalize_dtype(jnp.float64)
    if emission is GaussianNIW:
        emit = GaussianNIW.make_prior(K, obs_dim, dtype=dtype, **emission_kw)
    elif emission is DiagonalGaussianNIG:
        emit = DiagonalGaussianNIG.make_prior(K, obs_dim, dtype=dtype, **emission_kw)
    elif emission is MultinomialDirichlet:
        emit = MultinomialDirichlet.make_prior(K, num_symbols, dtype=dtype, **emission_kw)
    elif emission is PoissonGamma:
        emit = PoissonGamma.make_prior(K, obs_dim, dtype=dtype, **emission_kw)
    else:
        raise ValueError(f"unknown emission family {emission}")
    return HMMParams(
        init=jnp.full((K,), alpha_init, dtype),
        trans=jnp.full((K, K), alpha_tran, dtype),
        emit=emit,
    )


def _farthest_point_means(key: jax.Array, flat: jax.Array, K: int) -> jax.Array:
    """k-means++-style seeding: start at a random point, then greedily take
    the point farthest from all chosen so far. Avoids the classic VB local
    optimum where two nearby clusters share one init point and a state dies.
    Subsamples to <= 4096 points so the distance matrix stays tiny."""
    N = flat.shape[0]
    sub = flat[jax.random.permutation(key, N)[: min(N, 4096)]]
    first = sub[jax.random.randint(key, (), 0, sub.shape[0])]
    means0 = jnp.tile(first[None], (K, 1))

    def pick(i, means):
        d = jnp.min(
            jnp.sum((sub[:, None, :] - means[None, :, :]) ** 2, -1)
            + jnp.where(jnp.arange(K)[None, :] < i, 0.0, jnp.inf),
            axis=1,
        )
        return means.at[i].set(sub[jnp.argmax(d)])

    return jax.lax.fori_loop(1, K, pick, means0)


@f32_matmuls
def init_params(
    key: jax.Array,
    prior: HMMParams,
    emission,
    obs_sample: jax.Array | None = None,
) -> HMMParams:
    """Randomized initial variational params (reference: prior + noise, and
    Gaussian means seeded at observations; we use farthest-point seeding)."""
    K = prior.init.shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    init = prior.init + jax.random.uniform(k1, prior.init.shape, prior.init.dtype, 0.5, 1.5)
    trans = prior.trans + jax.random.uniform(k2, prior.trans.shape, prior.trans.dtype, 0.5, 1.5)
    emit = prior.emit
    if emission in (GaussianNIW, DiagonalGaussianNIG) and obs_sample is not None:
        flat = obs_sample.reshape(-1, obs_sample.shape[-1]).astype(prior.emit.mean.dtype)
        emit = emit._replace(mean=_farthest_point_means(k3, flat, K))
    elif emission is MultinomialDirichlet:
        emit = prior.emit + jax.random.uniform(k3, prior.emit.shape, prior.emit.dtype, 0.0, 1.0)
    elif emission is PoissonGamma and obs_sample is not None:
        # seed posterior-mean rates E[lambda] = a/b at farthest-point
        # count vectors (the Gaussian families' seeding, in rate space)
        flat = obs_sample.reshape(-1, obs_sample.shape[-1]).astype(prior.emit.a.dtype)
        m = jnp.maximum(_farthest_point_means(k3, flat, K), 0.1)
        emit = emit._replace(a=m * prior.emit.b)
    return HMMParams(init=init, trans=trans, emit=emit)


def expected_log_params(params: HMMParams) -> tuple[jax.Array, jax.Array]:
    """(E[log pi], E[log A]) — the variational pi~/A~ in log space."""
    return dirichlet.expected_log_probs(params.init), dirichlet.expected_log_probs(
        params.trans
    )


def global_kl(params: HMMParams, prior: HMMParams, emission) -> jax.Array:
    """KL(q(pi)||p) + sum_k KL(q(A_k.)||p) + sum_k KL(q(phi_k)||p)."""
    return (
        dirichlet.kl(params.init, prior.init)
        + jnp.sum(dirichlet.kl(params.trans, prior.trans))
        + emission.kl(params.emit, prior.emit)
    )


# Above this vocabulary size, one-hot feature matmuls for multinomial stats
# materialize an (N, V) array bigger than the gathered likelihoods are worth;
# switch to a segment-sum (scatter-add) that never builds the one-hot.
ONE_HOT_MAX_V = 256


def emission_flat_stats(emission, emit_params, gamma: jax.Array, obs: jax.Array):
    """Emission sufficient stats with all leading/time axes flattened.

    gamma (..., K) weights aligned with obs (..., D) or int obs (...,).
    Contracts everything but K (and trailing obs dims) in one matmul
    (large-vocabulary multinomials use a segment-sum instead — the dense
    (N, V) one-hot would dwarf every other array in the E-step).
    """
    K = gamma.shape[-1]
    g2 = gamma.reshape(-1, K)
    if emission is MultinomialDirichlet:
        y2 = obs.reshape(-1)
        V = emit_params.shape[-1]
        if V > ONE_HOT_MAX_V:
            return jnp.swapaxes(
                jax.ops.segment_sum(g2, y2, num_segments=V), 0, 1
            )  # (K, V)
        return MultinomialDirichlet.make_suff_stats(V)(g2, y2)
    y2 = obs.reshape(-1, obs.shape[-1])
    return emission.suff_stats(g2, y2)
