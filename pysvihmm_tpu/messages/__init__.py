"""Message-passing kernels: the E-step layer (reference L1, SURVEY.md §1).

Three interchangeable implementations of the same FBResult contract:
  * ``scan``   — `lax.scan`, O(T K^2), sequential in T, vmap over sequences
                 turns each step into a (B, K) @ (K, K) matmul. The
                 batched path off CUDA.
  * ``pallas`` — the same recursion as two Triton kernels
                 (messages/pallas_fb.py), one launch per sweep. The
                 batched path on a CUDA device.
  * ``assoc``  — `lax.associative_scan` prefix/suffix matrix products,
                 O(T K^3) flops, O(log T) depth. For a single long chain
                 on one device.
  * ``grad``   — sufficient stats as gradients of the log-normalizer
                 (d logZ / d log_A = sum_t xi_t, d/d log_lik = gamma,
                 d/d log_pi = gamma_0). One code path, consistency oracle.

Exact cross-agreement among all three is tested in tests/test_messages.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .scan_fb import (
    FBResult,
    backward,
    ffbs_sample,
    forward,
    forward_backward,
    forward_filter_log,
    log_normalizer,
    viterbi,
)
from .assoc_fb import forward_backward_assoc, log_normalizer_assoc
from .blocked import forward_backward_blocked, forward_backward_blocked_stream
from .state_sharded import state_sharded_forward_backward
from .time_sharded import (
    time_sharded_forward_backward,
    time_sharded_forward_backward_batched,
)


def e_step_grad(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,
    method: str = "scan",
) -> FBResult:
    """E-step via autodiff of the log-normalizer (generating-function identity)."""
    fn = log_normalizer if method == "scan" else log_normalizer_assoc
    log_z, (init_stats, trans_stats, gamma) = jax.value_and_grad(
        fn, argnums=(0, 1, 2)
    )(log_pi, log_A, log_lik)
    return FBResult(
        gamma=gamma,
        log_z=log_z,
        trans_stats=trans_stats,
        init_stats=init_stats,
        log_c=None,
    )


def on_cuda() -> bool:
    """True when computations run on a CUDA device: the one backend that
    compiles the Triton kernels of :mod:`.pallas_fb`.

    Reads the configured default device first (a test harness may pin the
    CPU while a GPU is present), then the default backend."""
    dd = jax.config.jax_default_device
    if dd is not None:
        return getattr(dd, "platform", "") == "gpu"
    return jax.default_backend() == "gpu"


METHODS = ("pallas", "scan", "assoc", "blocked", "grad")


def resolve_method(method: str) -> str:
    """Resolve the user-facing ``method="auto"`` to a concrete E-step path.

    "auto" is the forward-backward kernel ("pallas") on a CUDA device and
    `lax.scan` everywhere else. Resolution happens at trace time (the
    backend is static under jit); an explicit method in :data:`METHODS`
    passes through, and "pallas" off CUDA then fails in
    :func:`e_step_batched` unless the caller asks for the interpreter. Any
    other name raises.
    """
    if method == "auto":
        return "pallas" if on_cuda() else "scan"
    if method not in METHODS:
        raise ValueError(f"unknown E-step method {method!r}: 'auto' or one of {METHODS}")
    return method


def plan_window(method: str, keep_len: int, buffer: int):
    """Resolve the E-step method and window geometry of a windowed engine.

    Single source of truth for svi/metaobs/data-parallel ``make_step``.
    Returns (resolved_method, W, b_left): the window W = keep_len +
    2*buffer, with the kept region ``b_left`` steps in from its left edge.
    """
    return resolve_method(method), keep_len + 2 * buffer, buffer


def e_step_batched(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,  # (B, T, K)
    weights: jax.Array | None = None,  # (B, T) kept-mask
    method: str = "auto",
    interpret: bool = False,
) -> FBResult:
    """Batched E-step over (B, T, K) likelihoods — the engines' entry point.

    Contract: gamma (B, T, K), log_z (B,), log_c (B, T), init_stats (B, K)
    per sequence; trans_stats ALWAYS summed over the batch, shape (K, K)
    (what every global update consumes). method="pallas" runs the
    forward-backward kernels (messages/pallas_fb.py), which compile only
    for a CUDA device; ``interpret=True`` runs them in the Pallas
    interpreter instead (tests). Other methods vmap :func:`e_step`.
    """
    method = resolve_method(method)
    if method == "pallas":
        if not (interpret or on_cuda()):
            raise ValueError(
                'method="pallas" needs a CUDA device (or interpret=True); '
                f"the default backend is {jax.default_backend()!r}"
            )
        from .pallas_fb import pallas_forward_backward_batched

        return pallas_forward_backward_batched(
            log_pi, log_A, log_lik, weights=weights, interpret=interpret
        )
    if weights is None:
        fb = jax.vmap(lambda l: e_step(log_pi, log_A, l, method=method))(log_lik)
    else:
        fb = jax.vmap(
            lambda l, w: e_step(log_pi, log_A, l, weights=w, method=method)
        )(log_lik, weights)
    return fb._replace(trans_stats=jnp.sum(fb.trans_stats, axis=0))


def e_step(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,
    weights: jax.Array | None = None,
    method: str = "scan",
) -> FBResult:
    """Unified E-step over one sequence (vmap over leading batch as needed)."""
    if method == "scan":
        return forward_backward(log_pi, log_A, log_lik, weights)
    if method == "assoc":
        return forward_backward_assoc(log_pi, log_A, log_lik, weights)
    if method == "blocked":
        return forward_backward_blocked(log_pi, log_A, log_lik, weights)
    if method == "grad":
        if weights is not None:
            raise ValueError("grad e-step does not support buffer weights")
        return e_step_grad(log_pi, log_A, log_lik)
    raise ValueError(f"unknown e_step method: {method}")


__all__ = [
    "FBResult",
    "forward",
    "backward",
    "forward_backward",
    "forward_backward_assoc",
    "forward_backward_blocked",
    "forward_backward_blocked_stream",
    "state_sharded_forward_backward",
    "time_sharded_forward_backward",
    "time_sharded_forward_backward_batched",
    "forward_filter_log",
    "log_normalizer",
    "log_normalizer_assoc",
    "viterbi",
    "ffbs_sample",
    "e_step",
    "e_step_batched",
    "e_step_grad",
    "on_cuda",
    "plan_window",
    "resolve_method",
]
