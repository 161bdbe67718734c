"""Forward-backward message passing as `lax.scan` — the E-step hot kernel.

Replacement for the reference's Cython forward-backward extension
(``pysvihmm`` ``setup.py build_ext`` fast path + the numpy fallback in
``hmmbase.py`` — reconstructed, SURVEY.md §2.3). Instead of a C loop over one
sequence, the scan carries a whole *batch* of sequences: each time step is a
(B, K) @ (K, K) matmul plus fused elementwise rescaling. `vmap`/sharding over
the batch axis is how this scales to many devices. On a CUDA device the
batched E-step runs messages/pallas_fb.py's kernels instead (same math).

Math (normalized-space with per-step scaling constants, matching the
reference's numerics; Foti et al. 2014, Rabiner 1989):

    alpha_t ∝ (alpha_{t-1} @ A~) * lik_t          c_t = sum_k(...)
    beta_t  ∝ A~ @ (lik_{t+1} * beta_{t+1})
    log Z   = sum_t log c_t (+ max-shift corrections)
    gamma_t ∝ alpha_t * beta_t
    xi_t    ∝ alpha_t ⊗ (A~ * (lik_{t+1} beta_{t+1}))

where A~ = exp(E_q[log A]) (sub-stochastic), pi~ = exp(E_q[log pi]), and
lik_t = exp(loglik_t - max_k loglik_tk). The T x K x K pairwise marginals are
never materialized: the backward scan accumulates sum_t w_t * xi_t on the fly
(K x K carry), with optional per-step weights w_t implementing SVI's
buffered-subchain discard (paper §3.2).

All public entry points take a single sequence (T, ...) and are `vmap`-able.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class FBResult(NamedTuple):
    """Posterior quantities from one forward-backward sweep.

    gamma:        (T, K) smoothed state marginals q(z_t).
    log_z:        ()     variational log-normalizer log p~(y).
    trans_stats:  (K, K) sum_t w_t xi_t — expected transition counts.
    init_stats:   (K,)   w_0 * gamma_0 — expected initial-state counts.
    log_c:        (T,)   per-step log scaling constants (sum = log_z); used
                         for SVI's noisy lower-bound estimate over kept steps.
    """

    gamma: jax.Array
    log_z: jax.Array
    trans_stats: jax.Array
    init_stats: jax.Array
    log_c: jax.Array


def _normalize_loglik(log_lik: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-step max-shift: returns (lik in [0,1], shifts (T,))."""
    m = lax.stop_gradient(jnp.max(log_lik, axis=-1))
    lik = jnp.exp(log_lik - m[..., None])
    return lik, m


def forward(
    log_pi: jax.Array, log_A: jax.Array, log_lik: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Normalized forward recursion.

    Returns (alpha (T, K) normalized filtered marginals-tilde, log_z ()).
    Differentiable: d log_z / d log_lik = gamma, d/d log_A = sum_t xi_t,
    d/d log_pi = gamma_0 (the generating-function identity used by
    :func:`e_step_grad` in grad_stats.py).
    """
    alpha, log_z, _ = forward_with_logc(log_pi, log_A, log_lik)
    return alpha, log_z


def forward_with_logc(
    log_pi: jax.Array, log_A: jax.Array, log_lik: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Like :func:`forward` but also returns per-step log_c (T,)."""
    A_tilde = jnp.exp(log_A)
    lik, shifts = _normalize_loglik(log_lik)
    a0 = jnp.exp(log_pi) * lik[0]
    c0 = jnp.sum(a0)
    alpha0 = a0 / c0

    def step(alpha, lik_t):
        a = (alpha @ A_tilde) * lik_t
        c = jnp.sum(a)
        return a / c, (a / c, jnp.log(c))

    _, (alphas, logcs) = lax.scan(step, alpha0, lik[1:])
    alpha = jnp.concatenate([alpha0[None], alphas], axis=0)
    log_c = jnp.concatenate([jnp.log(c0)[None], logcs], axis=0) + shifts
    return alpha, jnp.sum(log_c), log_c


def backward(
    log_A: jax.Array, log_lik: jax.Array, beta_last: jax.Array | None = None
) -> jax.Array:
    """Normalized backward messages beta (T, K) (each row rescaled to sum K).

    beta_last: optional seed at t = T-1 (the time-sharded tiles pass their
    boundary message here); defaults to the uniform right-edge condition.
    """
    A_tilde = jnp.exp(log_A)
    lik, _ = _normalize_loglik(log_lik)
    if beta_last is None:
        # derive from lik so the carry keeps lik's sharding/vma type under shard_map
        beta_last = jnp.ones_like(lik[0])

    def step(beta, lik_t1):
        b = A_tilde @ (lik_t1 * beta)
        b = b / jnp.sum(b)
        return b, b

    _, betas = lax.scan(step, beta_last, lik[1:], reverse=True)
    return jnp.concatenate([betas, beta_last[None]], axis=0)


def forward_backward(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,
    weights: jax.Array | None = None,
) -> FBResult:
    """Full smoothing pass with on-the-fly sufficient-stat accumulation.

    weights: optional (T,) 0/1 mask of *kept* positions (SVI buffer discard,
    Foti et al. §3.2). gamma_t is weighted into emission-side use by the
    caller; here weights gate init_stats (w_0) and trans_stats (a transition
    t -> t+1 is kept iff w_t == w_{t+1} == 1).

    Batched trick: since each normalized pairwise marginal factors as
    xi_t = outer(alpha_t / n_t, lik_{t+1} * beta_{t+1}) ⊙ A~ with scalar
    normalizer n_t, the *summed* transition stats collapse to

        sum_t w_t xi_t = A~ ⊙ ((alpha ⊙ w/n)[:-1]^T @ (lik * beta)[1:])

    — one (K, T) @ (T, K) matmul instead of a sequential K x K
    accumulation. Memory stays O(T K); the T x K x K xi tensor is never
    materialized.
    """
    A_tilde = jnp.exp(log_A)
    lik, _ = _normalize_loglik(log_lik)

    alpha, log_z, log_c = forward_with_logc(log_pi, log_A, log_lik)
    beta = backward(log_A, log_lik)

    if weights is None:
        w = jnp.ones((log_lik.shape[0],), dtype=log_lik.dtype)
    else:
        w = weights.astype(log_lik.dtype)

    g = alpha * beta
    gamma = g / jnp.sum(g, axis=-1, keepdims=True)

    bl = lik[1:] * beta[1:]  # (T-1, K)
    n = jnp.einsum("tk,tk->t", alpha[:-1] @ A_tilde, bl)  # xi_t normalizers
    w_pair = w[:-1] * w[1:]
    alpha_w = alpha[:-1] * (w_pair / n)[:, None]
    trans_stats = A_tilde * (alpha_w.T @ bl)

    init_stats = w[0] * gamma[0]
    return FBResult(
        gamma=gamma,
        log_z=log_z,
        trans_stats=trans_stats,
        init_stats=init_stats,
        log_c=log_c,
    )


def log_normalizer(log_pi: jax.Array, log_A: jax.Array, log_lik: jax.Array) -> jax.Array:
    """log p~(y) only (forward pass); the autodiff generating function."""
    _, log_z = forward(log_pi, log_A, log_lik)
    return log_z


def viterbi(log_pi: jax.Array, log_A: jax.Array, log_lik: jax.Array) -> jax.Array:
    """MAP state path via max-plus forward scan + backtrace. Returns (T,) int32."""
    def fwd_step(delta, ll_t):
        scores = delta[:, None] + log_A  # (K, K): from i to j
        best = jnp.max(scores, axis=0) + ll_t
        arg = jnp.argmax(scores, axis=0)
        return best, arg

    delta0 = log_pi + log_lik[0]
    deltaT, args = lax.scan(fwd_step, delta0, log_lik[1:])
    zT = jnp.argmax(deltaT).astype(jnp.int32)

    def back_step(z_next, arg_t):
        z = arg_t[z_next].astype(jnp.int32)
        return z, z

    _, zs = lax.scan(back_step, zT, args, reverse=True)
    return jnp.concatenate([zs, zT[None]], axis=0)


def forward_filter_log(
    log_pi: jax.Array, log_A: jax.Array, log_lik: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Log-space filtered marginals log alpha (T, K) + log_z, for FFBS/eval.

    Uses logsumexp recursion (no exp of log_A needed) — slower than the
    normalized-space scan but convenient where log alpha is required.
    """
    from jax.scipy.special import logsumexp

    la0 = log_pi + log_lik[0]

    def step(la, ll_t):
        la_next = logsumexp(la[:, None] + log_A, axis=0) + ll_t
        return la_next, la_next

    laT, las = lax.scan(step, la0, log_lik[1:])
    log_alpha = jnp.concatenate([la0[None], las], axis=0)
    log_z = logsumexp(laT)
    return log_alpha, log_z


def ffbs_sample(
    key: jax.Array, log_pi: jax.Array, log_A: jax.Array, log_lik: jax.Array
) -> jax.Array:
    """Forward-filter backward-sample: one posterior draw of z (T,) int32.

    The Gibbs-engine analog of the reference's comparison samplers
    (SURVEY.md north-star: "Gibbs-style comparisons").
    """
    log_alpha, _ = forward_filter_log(log_pi, log_A, log_lik)
    T = log_lik.shape[0]
    keys = jax.random.split(key, T)
    zT = jax.random.categorical(keys[T - 1], log_alpha[-1]).astype(jnp.int32)

    def step(z_next, inp):
        la_t, k = inp
        logits = la_t + log_A[:, z_next]
        z = jax.random.categorical(k, logits).astype(jnp.int32)
        return z, z

    _, zs = lax.scan(step, zT, (log_alpha[:-1], keys[: T - 1]), reverse=True)
    return jnp.concatenate([zs, zT[None]], axis=0)
