"""Parallel-in-time forward-backward via `lax.associative_scan`.

Temporal parallelization of HMM smoothing (Särkkä & García-Fernández,
arXiv:2102.05743 — PAPERS.md): the forward recursion is a product of
per-timestep K x K matrices M_t[i, j] = A~[i, j] * lik_t[j], so prefix
products give all alpha_t in O(log T) depth; suffix products give beta_t.
Each associative combine is a batched (K, K) @ (K, K) matmul, so a single
long chain fills the device instead of serializing T steps. This is the
parallel answer to the reference's Cython sequential loop for
the single-long-chain regime (SURVEY.md §2.3, §5 "long-context").

Representation: (M, s) ≡ exp(s) * M with M kept max-normalized so products
neither overflow nor underflow at T = 100k+.

Trade-off vs scan_fb: O(T K^3) flops (vs O(T K^2)) but O(log T) depth and
full matmul utilization; stores T x K x K prefix matrices, so for large T use
:func:`pysvihmm_tpu.messages.blocked.blocked_e_step` which runs this inside
fixed-size time tiles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .scan_fb import FBResult, _normalize_loglik


def _combine(a, b):
    """(Ma, sa) ⊕ (Mb, sb) -> normalized (Ma @ Mb, sa + sb + log c)."""
    Ma, sa = a
    Mb, sb = b
    P = jnp.matmul(Ma, Mb, preferred_element_type=Ma.dtype)
    c = jnp.max(P, axis=(-2, -1), keepdims=True)
    return P / c, sa + sb + jnp.log(c[..., 0, 0])


def forward_backward_assoc(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,
    weights: jax.Array | None = None,
) -> FBResult:
    """Same contract as :func:`scan_fb.forward_backward`, log-depth in T."""
    T, K = log_lik.shape
    A_tilde = jnp.exp(log_A)
    lik, shifts = _normalize_loglik(log_lik)

    if T == 1:
        # no transitions: the chain posterior is one categorical
        v0 = jnp.exp(log_pi) * lik[0]
        c0 = jnp.sum(v0)
        gamma0 = v0 / c0
        w0 = 1.0 if weights is None else weights.astype(log_lik.dtype)[0]
        log_z = jnp.log(c0) + jnp.sum(shifts)
        return FBResult(
            gamma=gamma0[None],
            log_z=log_z,
            trans_stats=jnp.zeros((K, K), log_lik.dtype),
            init_stats=w0 * gamma0,
            log_c=log_z[None],
        )

    # M_t for t = 1..T-1: transition into step t.
    M = A_tilde[None, :, :] * lik[1:, None, :]  # (T-1, K, K)
    m0 = jnp.max(M, axis=(-2, -1), keepdims=True)
    M_n = M / m0
    s0 = jnp.log(m0[..., 0, 0])

    v0 = jnp.exp(log_pi) * lik[0]
    c0 = jnp.sum(v0)
    alpha0 = v0 / c0

    # Prefix products P_t = M_1 ... M_t  (inclusive).
    P, sP = lax.associative_scan(_combine, (M_n, s0))
    alpha_un = jnp.einsum("k,tkj->tj", alpha0, P)  # (T-1, K)
    alpha_sums = jnp.sum(alpha_un, axis=-1)
    alpha = jnp.concatenate([alpha0[None], alpha_un / alpha_sums[:, None]], axis=0)

    # Per-step log_c from differences of cumulative log-mass (parallel).
    cums = jnp.log(alpha_sums) + sP  # (T-1,) cumulative after steps 1..T-1
    log_c = jnp.concatenate([jnp.log(c0)[None], jnp.diff(jnp.concatenate([jnp.zeros((1,), cums.dtype), cums]))]) + shifts

    log_z = jnp.log(c0) + cums[-1] + jnp.sum(shifts)

    # Suffix products: with reverse=True, associative_scan composes in
    # *reversed* order (verified empirically), so feed transposed elements:
    # S'_t = M_{T-1}^T ... M_{t+1}^T = (M_{t+1} ... M_{T-1})^T, and
    # beta_t = (M_{t+1} ... M_{T-1}) @ 1 = colsum(S'_t).
    S, _ = lax.associative_scan(
        _combine, (jnp.swapaxes(M_n, -1, -2), s0), reverse=True
    )
    beta_un = jnp.sum(S, axis=-2)  # (T-1, K) rows t = 0..T-2
    beta = jnp.concatenate(
        [beta_un / jnp.sum(beta_un, axis=-1, keepdims=True),
         jnp.ones((1, K), dtype=log_lik.dtype)],
        axis=0,
    )

    g = alpha * beta
    gamma = g / jnp.sum(g, axis=-1, keepdims=True)

    if weights is None:
        w = jnp.ones((T,), dtype=log_lik.dtype)
    else:
        w = weights.astype(log_lik.dtype)

    bl = lik[1:] * beta[1:]
    n = jnp.einsum("tk,tk->t", alpha[:-1] @ A_tilde, bl)
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


def log_normalizer_assoc(
    log_pi: jax.Array, log_A: jax.Array, log_lik: jax.Array
) -> jax.Array:
    """log p~(y) via a single prefix-product reduction (associative, log-depth)."""
    A_tilde = jnp.exp(log_A)
    lik, shifts = _normalize_loglik(log_lik)
    if log_lik.shape[0] == 1:
        return jnp.log(jnp.sum(jnp.exp(log_pi) * lik[0])) + jnp.sum(shifts)
    M = A_tilde[None, :, :] * lik[1:, None, :]
    m0 = jnp.max(M, axis=(-2, -1), keepdims=True)
    M_n = M / m0
    s0 = jnp.log(m0[..., 0, 0])
    P, sP = lax.associative_scan(_combine, (M_n, s0))
    v0 = jnp.exp(log_pi) * lik[0]
    c0 = jnp.sum(v0)
    total = jnp.sum((v0 / c0) @ P[-1])
    return jnp.log(c0) + jnp.log(total) + sP[-1] + jnp.sum(shifts)
