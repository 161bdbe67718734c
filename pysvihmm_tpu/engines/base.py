"""Shared engine machinery: batched local E-steps, ELBO, decoding.

Replaces the helpers on ``VariationalHMMBase`` (``pysvihmm/hmmbase.py``,
reconstructed — SURVEY.md §2.2/§3): ``local_update``, ``lower_bound``,
state decoding. Everything is a pure function of (params, prior, obs);
engines differ only in *which data* they feed the local step and *how* they
turn stats into the next global state.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import messages
from ..models.hmm import (
    HMMParams,
    emission_flat_stats,
    expected_log_params,
    global_kl,
)
from ..utils.precision import f32_matmuls


class LocalStats(NamedTuple):
    """Summed expected sufficient statistics from a batch local step."""

    init: jax.Array  # (K,)
    trans: jax.Array  # (K, K)
    emit: object  # emission-family stats pytree, leading K
    log_z: jax.Array  # () summed variational log-normalizer


@f32_matmuls
def batch_local_step(
    params: HMMParams,
    emission,
    obs: jax.Array,
    method: str = "auto",
    weights: jax.Array | None = None,
    need_gamma: bool = True,
    interpret: bool = False,
) -> tuple[LocalStats, jax.Array]:
    """Full local update over a batch of sequences.

    obs: (B, T, D) float or (B, T) int. weights: optional (B, T) kept-mask.
    Returns (summed stats, gamma (B, T, K) — or None when need_gamma=False;
    training steps consume only the stats).

    Three layers, each plain XLA except the recursion: expected
    log-likelihoods (B, T, K); the forward-backward recursion through
    messages.e_step_batched ("auto" is the Triton kernel on a CUDA device
    and `lax.scan` elsewhere; ``interpret=True`` runs the kernel in the
    Pallas interpreter); the gamma-weighted emission statistics.
    """
    log_pi, log_A = expected_log_params(params)
    ll = emission.expected_log_likelihood(params.emit, obs)  # (B, T, K)
    fb = messages.e_step_batched(
        log_pi, log_A, ll, weights=weights, method=method, interpret=interpret
    )
    gamma_w = fb.gamma if weights is None else fb.gamma * weights[..., None]
    emit_stats = emission_flat_stats(emission, params.emit, gamma_w, obs)
    # every batched path returns trans_stats already summed over sequences
    stats = LocalStats(
        init=jnp.sum(fb.init_stats, axis=0),
        trans=fb.trans_stats,
        emit=emit_stats,
        log_z=jnp.sum(fb.log_z),
    )
    return stats, (fb.gamma if need_gamma else None)


@f32_matmuls
def long_chain_local_stats(
    params: HMMParams,
    emission,
    chain: jax.Array,
    block_size: int = 256,
    impl: str | None = None,
    time_minor: bool = False,
) -> LocalStats:
    """Exact full-chain local stats for ONE very long chain, streaming.

    Semantically `batch_local_step(params, emission, chain[None],
    method="blocked", need_gamma=False)[0]`, but gamma and the per-
    transition K x K matrices are never materialized: emission sufficient
    stats are reduced blockwise inside the backward sweep
    (messages/blocked.py::forward_backward_blocked_stream). Peak memory is
    O(T K), so K = 64 chains of T = 10M+ steps fit one chip's HBM — the
    regime of the reference paper's T~250M chromatin experiment (Foti et
    al. 2014 §4), which the non-streaming blocked path cannot reach.

    Call under `jax.jit` (static: emission, block_size, impl). Eager calls
    work but pay per-op dispatch latency on every one of the sweep's ops.

    impl: "fused" (default — the likelihood-fused two-phase tier,
    messages/stream_fused.py: likelihoods computed per chunk from the raw
    observations, so the (T, K) array never exists in device memory),
    "twophase" (the (T, K) log-lik materialized up front; also via
    PYSVIHMM_STREAM_IMPL=twophase), or "assoc" (the associative-scan
    tier). All are exact and f64-parity-tested against each other.
    """
    from ..messages.blocked import (
        forward_backward_blocked_stream,
        forward_backward_blocked_twophase,
    )

    if impl is None:
        impl = os.environ.get("PYSVIHMM_STREAM_IMPL", "fused")
    if time_minor and impl != "fused":
        # the non-fused tiers consume a (T, K) likelihood computed from a
        # TIME-MAJOR chain; silently feeding them (D, T) would produce a
        # confusing downstream shape error (or, at T == D, wrong stats)
        raise ValueError(
            f"time_minor=True requires impl='fused' (got impl={impl!r})"
        )

    stat_fn = lambda g, y: emission_flat_stats(emission, params.emit, g, y)
    log_pi, log_A = expected_log_params(params)
    if impl == "fused":
        from ..messages.stream_fused import forward_backward_fused_twophase

        r = forward_backward_fused_twophase(
            log_pi,
            log_A,
            chain,
            _long_chain_ell_fn(params, emission),
            block_size=block_size,
            stat_fn=stat_fn,
            stat_init=emission.zero_stats(params.emit),
            # time_minor: the chain arrives feature-major (D, T)
            time_minor=time_minor,
        )
    else:
        fb_stream = {
            "twophase": forward_backward_blocked_twophase,
            "assoc": forward_backward_blocked_stream,
        }[impl]
        ll = emission.expected_log_likelihood(params.emit, chain)  # (T, K)
        r = fb_stream(
            log_pi,
            log_A,
            ll,
            block_size=block_size,
            stat_xs=chain,
            stat_fn=stat_fn,
            stat_init=emission.zero_stats(params.emit),
        )
    return LocalStats(
        init=r.init_stats, trans=r.trans_stats, emit=r.acc, log_z=r.log_z
    )


def _long_chain_ell_fn(params, emission):
    """Per-chunk expected-log-likelihood closure for the fused streaming
    tiers: the Gaussian families get their feature-matmul form (one
    feats @ W per chunk, at the caller's full-f32 precision —
    utils/precision.py); families without feature form fall back to
    expected_log_likelihood directly."""
    if hasattr(emission, "ell_features"):
        W = emission.ell_feature_matrix(params.emit)
        return lambda rows: emission.ell_features(rows) @ W
    return lambda rows: emission.expected_log_likelihood(params.emit, rows)


@f32_matmuls
def long_chain_decode(
    params: HMMParams,
    emission,
    chain: jax.Array,
    block_size: int = 1024,
    chunks: int = 8,
    time_minor: bool = False,
) -> jax.Array:
    """Posterior-marginal decode of ONE long chain, streaming: (T,) int32.

    Same argmax_k gamma_tk rule as :func:`decode` (the reference's decode
    — SURVEY.md:140) but gamma is never materialized: the fused streaming
    backward sweep emits each step's argmax directly
    (messages/stream_fused.py emit_argmax), so the decode reaches the
    same T≈100M+ single-chip scale as the streaming E-step — the
    reference paper's chromatin segmentation deliverable at T≈250M
    (SURVEY.md:284). Call under jit (static: emission, block_size,
    chunks).
    """
    from ..messages.stream_fused import forward_backward_fused_twophase

    log_pi, log_A = expected_log_params(params)
    r = forward_backward_fused_twophase(
        log_pi,
        log_A,
        chain,
        _long_chain_ell_fn(params, emission),
        block_size=block_size,
        chunks=chunks,
        emit_argmax=True,
        time_minor=time_minor,
    )
    return r.z


@f32_matmuls
def windowed_local_step(
    params: HMMParams,
    emission,
    windows: jax.Array,  # (B, W, D) float or (B, W) int
    maskf: jax.Array,  # (B, W) kept-mask (0/1 floats)
    offs: jax.Array,  # (B,) kept-region offset inside each window
    method: str = "auto",
    interpret: bool = False,
) -> tuple[object, jax.Array, jax.Array, jax.Array]:
    """Shared local step of the windowed engines (svi/metaobs subchains).

    Returns (emit_stats, trans_stats, gamma_at_off, log_c): emission stats
    kept-mask-gated and summed over windows; trans_stats pair-gated and
    summed (shape (K, K)); gamma_at_off (B, K) = each window's smoothed
    marginal at its kept-region offset (the initial-state stats site);
    log_c (B, W) per-step log normalizers (mask applies to their sum).
    """
    log_pi, log_A = expected_log_params(params)
    ll = emission.expected_log_likelihood(params.emit, windows)
    fb = messages.e_step_batched(
        log_pi, log_A, ll, weights=maskf, method=method, interpret=interpret
    )
    gamma_w = fb.gamma * maskf[..., None]
    emit_stats = emission_flat_stats(emission, params.emit, gamma_w, windows)
    gamma_at = jnp.take_along_axis(
        fb.gamma, offs[:, None, None], axis=1
    )[:, 0, :]
    return emit_stats, fb.trans_stats, gamma_at, fb.log_c


def elbo_from_stats(
    params: HMMParams, prior: HMMParams, emission, log_z: jax.Array
) -> jax.Array:
    """ELBO = sum_seqs log Z~ - KL(q(theta) || p(theta)) (SURVEY.md §2.1)."""
    return log_z - global_kl(params, prior, emission)


@f32_matmuls
def lower_bound(
    params: HMMParams, prior: HMMParams, emission, obs: jax.Array, method: str = "auto"
) -> jax.Array:
    """Exact full-data ELBO at the current global state (fresh local step)."""
    stats, _ = batch_local_step(params, emission, obs, method, need_gamma=False)
    return elbo_from_stats(params, prior, emission, stats.log_z)


def decode(params: HMMParams, emission, obs: jax.Array) -> jax.Array:
    """Posterior-marginal state decode: argmax_k gamma_tk per sequence (B, T)."""
    _, gamma = batch_local_step(params, emission, obs)
    return jnp.argmax(gamma, axis=-1)


@f32_matmuls
def viterbi_decode(params: HMMParams, emission, obs: jax.Array) -> jax.Array:
    """MAP path under the variational-mean parameters (B, T)."""
    log_pi, log_A = expected_log_params(params)
    ll = emission.expected_log_likelihood(params.emit, obs)
    return jax.vmap(lambda l: messages.viterbi(log_pi, log_A, l))(ll)


@f32_matmuls
def predictive_log_likelihood(
    params: HMMParams, emission, obs: jax.Array, exact: bool = False
) -> jax.Array:
    """Held-out predictive log-likelihood via the forward filter.

    exact=False (default): posterior-mean plug-in parameters (pi_bar, A_bar,
    phi_bar) — the reference's behavior [``pred_logprob`` helpers, MED —
    SURVEY.md §2.2]. exact=True: emissions scored with the exact
    posterior-predictive density (Student-t / Dirichlet-multinomial),
    integrating out phi per observation.
    """
    from ..distributions import dirichlet

    log_pi = jnp.log(dirichlet.mean(params.init))
    log_A = jnp.log(dirichlet.mean(params.trans))
    if exact:
        ll = emission.predictive_log_likelihood(params.emit, obs)
    else:
        theta = emission.mean_params(params.emit)
        ll = emission.point_log_likelihood(theta, obs)
    _, log_z = jax.vmap(lambda l: messages.forward(log_pi, log_A, l))(ll)
    return jnp.sum(log_z)
