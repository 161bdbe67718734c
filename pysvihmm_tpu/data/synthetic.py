"""Synthetic HMM data generation (reference ``gen_synthetic.py``, SURVEY.md §3E).

Samples true parameters (or takes them), rolls the chain forward with
`lax.scan`, and returns (obs, true states, true params) for engine tests and
the paper-style experiments. Fully device-side and jit/vmap-friendly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..distributions.emissions import (
    DiagonalGaussianNIG,
    GaussianNIW,
    MultinomialDirichlet,
    PoissonGamma,
)


class TrueParams(NamedTuple):
    pi: jax.Array  # (K,)
    A: jax.Array  # (K, K)
    theta: object  # emission params: (mu, Sigma) or phi (K, V)


def _sticky_transitions(K: int, self_prob: float) -> jax.Array:
    """Sticky transition matrix: self_prob on the diagonal, rest uniform."""
    return jnp.full((K, K), (1.0 - self_prob) / (K - 1)) + (
        self_prob - (1.0 - self_prob) / (K - 1)
    ) * jnp.eye(K)


def make_gaussian_params(
    key: jax.Array,
    K: int,
    D: int,
    *,
    mean_scale: float = 5.0,
    cov_scale: float = 0.5,
    self_prob: float = 0.8,
) -> TrueParams:
    """Well-separated Gaussian states with sticky transitions (the reference's
    canonical small-K test regime, SURVEY.md §4)."""
    k1, k2 = jax.random.split(key)
    pi = jnp.full((K,), 1.0 / K)
    A = _sticky_transitions(K, self_prob)
    mu = mean_scale * jax.random.normal(k1, (K, D))
    sigma = cov_scale * jnp.broadcast_to(jnp.eye(D), (K, D, D))
    return TrueParams(pi=pi, A=A, theta=(mu, sigma))


def make_multinomial_params(
    key: jax.Array, K: int, V: int, *, concentration: float = 0.3, self_prob: float = 0.85
) -> TrueParams:
    """Sparse symbol distributions per state (text-like, BASELINE config 3)."""
    pi = jnp.full((K,), 1.0 / K)
    A = _sticky_transitions(K, self_prob)
    phi = jax.random.dirichlet(key, jnp.full((K, V), concentration))
    return TrueParams(pi=pi, A=A, theta=phi)


def sample_states(key: jax.Array, params: TrueParams, T: int) -> jax.Array:
    """One state path (T,) int32 via a categorical scan."""
    k0, ks = jax.random.split(key)
    log_A = jnp.log(params.A)
    z0 = jax.random.categorical(k0, jnp.log(params.pi)).astype(jnp.int32)
    keys = jax.random.split(ks, T - 1)

    def step(z, k):
        z_next = jax.random.categorical(k, log_A[z]).astype(jnp.int32)
        return z_next, z_next

    _, zs = jax.lax.scan(step, z0, keys)
    return jnp.concatenate([z0[None], zs])


def sample_states_fast(pi, A, T: int, rng, block: int = 4096):
    """HOST-side state-path sampler for T = tens-to-hundreds of millions.

    The naive per-step Python loop runs ~250k steps/s (r4's long-chain
    runner: ~40 s at T=10M — unusable at the reference paper's T≈250M
    chromatin scale, SURVEY.md:284). This vectorizes the inherently
    sequential rollout the same way the streaming FB tiers do: each step's
    inverse-CDF draw defines a random MAP state→state; per-block maps are
    composed vectorized over all blocks at once (two passes of (n_blocks,)
    gathers per in-block step), then a tiny boundary recursion threads the
    true entry state of every block. ~T·K bytes of scratch (int8 maps);
    ~50× the naive loop.

    pi (K,), A (K, K) numpy; rng a numpy Generator. Returns (T,) int32.
    """
    import numpy as np

    K = len(pi)
    if K > 127:
        raise ValueError(f"K={K} exceeds the int8 state-map limit (127)")
    pi = np.asarray(pi, np.float64)
    A_cum = np.cumsum(np.asarray(A, np.float64), axis=1)
    z0 = int(rng.choice(K, p=pi / pi.sum()))
    if T == 1:
        return np.array([z0], np.int32)
    n = T - 1
    nB = -(-n // block)
    u = rng.random(nB * block)  # padded tail draws are discarded below
    # per-step maps M[s, b, k] = next state from k under block b's step-s
    # draw; computed per ENTRY STATE as one searchsorted over all steps.
    # The clip guards the draws landing above a row's float-rounded
    # cumsum (A_cum[k, -1] can sit just below 1): at T=100M+ a handful of
    # such draws are EXPECTED, and an unclamped index K would crash the
    # gathers below.
    M = np.empty((K, nB * block), np.int8)
    for k in range(K):
        M[k] = np.minimum(
            np.searchsorted(A_cum[k], u, side="right"), K - 1
        ).astype(np.int8)
    M = np.ascontiguousarray(
        M.reshape(K, nB, block).transpose(2, 1, 0)
    )  # (block, nB, K)

    # compose each block's maps: V[b, k] = block-exit state given entry k
    V = np.broadcast_to(np.arange(K, dtype=np.int8), (nB, K)).copy()
    for s in range(block):
        V = np.take_along_axis(M[s], V.astype(np.intp), axis=1)

    # boundary recursion: entry state of every block
    z_bound = np.empty((nB,), np.int32)
    z_bound[0] = z0
    for b in range(nB - 1):
        z_bound[b + 1] = V[b, z_bound[b]]

    # replay within all blocks at once from the true entry states
    zs = np.empty((block, nB), np.int8)
    cur = z_bound.astype(np.intp)
    rows = np.arange(nB)
    for s in range(block):
        cur = M[s][rows, cur]
        zs[s] = cur
        cur = cur.astype(np.intp)
    z = np.empty((T,), np.int32)
    z[0] = z0
    z[1:] = zs.T.reshape(-1)[:n]
    return z


def gen_data(
    key: jax.Array,
    params: TrueParams,
    emission,
    *,
    num_seqs: int,
    T: int,
) -> tuple[jax.Array, jax.Array]:
    """Sample (obs, states). obs: (num_seqs, T, D) float or (num_seqs, T) int."""
    kz, ky = jax.random.split(key)
    zkeys = jax.random.split(kz, num_seqs)
    z = jax.vmap(lambda k: sample_states(k, params, T))(zkeys)  # (B, T)
    ykeys = jax.random.split(ky, num_seqs)
    y = jax.vmap(lambda k, zz: emission.sample_obs(k, params.theta, zz))(ykeys, z)
    return y, z


def gen_gaussian_dataset(
    key: jax.Array, K: int, D: int, num_seqs: int, T: int, **kw
) -> tuple[jax.Array, jax.Array, TrueParams]:
    kp, kd = jax.random.split(key)
    params = make_gaussian_params(kp, K, D, **kw)
    y, z = gen_data(kd, params, GaussianNIW, num_seqs=num_seqs, T=T)
    return y, z, params


def sample_sticky_states(
    key: jax.Array, K: int, self_prob: float, T: int
) -> jax.Array:
    """One state path (T,) int32 of the sticky chain of
    :func:`_sticky_transitions` with a uniform initial state, exactly and
    in parallel over T (no sequential rollout).

    A step stays with probability self_prob and otherwise moves to one of
    the other K-1 states uniformly, i.e. adds an offset d_t in {1..K-1}
    modulo K. So z_t = (z_0 + sum_{s<=t} d_s) mod K: a modular prefix sum.
    """
    k0, kj, ko = jax.random.split(key, 3)
    z0 = jax.random.randint(k0, (1,), 0, K, dtype=jnp.int32)
    jump = jax.random.uniform(kj, (T - 1,)) >= self_prob
    offset = jnp.where(jump, jax.random.randint(ko, (T - 1,), 1, K, dtype=jnp.int32), 0)
    steps = jnp.concatenate([z0, offset])
    return jax.lax.associative_scan(lambda a, b: (a + b) % K, steps)


def gen_gaussian_chain(
    key: jax.Array, K: int, D: int, T: int, *, self_prob: float = 0.8, **kw
) -> tuple[jax.Array, jax.Array, TrueParams]:
    """One long Gaussian chain (T, D) for the long-chain and SVI engines.

    Same model as :func:`gen_gaussian_dataset` with one sequence, but the
    state path comes from :func:`sample_sticky_states`, so T = 10^7+ costs
    a few parallel passes instead of T sequential scan steps.
    """
    kp, kz, ky = jax.random.split(key, 3)
    params = make_gaussian_params(kp, K, D, self_prob=self_prob, **kw)
    z = sample_sticky_states(kz, K, self_prob, T)
    y = GaussianNIW.sample_obs(ky, params.theta, z)
    return y, z, params


def make_diag_gaussian_params(
    key: jax.Array,
    K: int,
    D: int,
    *,
    mean_scale: float = 5.0,
    var_scale: float = 0.5,
    self_prob: float = 0.8,
) -> TrueParams:
    """Diagonal-covariance variant of :func:`make_gaussian_params`:
    theta = (mu (K, D), sigma2 (K, D)) with heterogeneous per-dim variances."""
    k1, k2 = jax.random.split(key)
    pi = jnp.full((K,), 1.0 / K)
    A = _sticky_transitions(K, self_prob)
    mu = mean_scale * jax.random.normal(k1, (K, D))
    sigma2 = var_scale * jax.random.uniform(k2, (K, D), minval=0.5, maxval=2.0)
    return TrueParams(pi=pi, A=A, theta=(mu, sigma2))


def gen_diag_gaussian_dataset(
    key: jax.Array, K: int, D: int, num_seqs: int, T: int, **kw
) -> tuple[jax.Array, jax.Array, TrueParams]:
    kp, kd = jax.random.split(key)
    params = make_diag_gaussian_params(kp, K, D, **kw)
    y, z = gen_data(kd, params, DiagonalGaussianNIG, num_seqs=num_seqs, T=T)
    return y, z, params


def gen_multinomial_dataset(
    key: jax.Array, K: int, V: int, num_seqs: int, T: int, **kw
) -> tuple[jax.Array, jax.Array, TrueParams]:
    kp, kd = jax.random.split(key)
    params = make_multinomial_params(kp, K, V, **kw)
    y, z = gen_data(kd, params, MultinomialDirichlet, num_seqs=num_seqs, T=T)
    return y, z, params


def make_poisson_params(
    key: jax.Array,
    K: int,
    D: int,
    *,
    rate_scale: float = 10.0,
    self_prob: float = 0.8,
) -> TrueParams:
    """Well-separated per-state rate vectors: theta = lambda (K, D) drawn
    log-uniform in [rate_scale/10, rate_scale] so states differ by up to
    10x per dimension."""
    pi = jnp.full((K,), 1.0 / K)
    A = _sticky_transitions(K, self_prob)
    u = jax.random.uniform(key, (K, D))
    lam = rate_scale / 10.0 * (10.0**u)
    return TrueParams(pi=pi, A=A, theta=lam)


def gen_poisson_dataset(
    key: jax.Array, K: int, D: int, num_seqs: int, T: int, **kw
) -> tuple[jax.Array, jax.Array, TrueParams]:
    kp, kd = jax.random.split(key)
    params = make_poisson_params(kp, K, D, **kw)
    y, z = gen_data(kd, params, PoissonGamma, num_seqs=num_seqs, T=T)
    return y, z, params
