"""Batched forward-backward as two Pallas kernels for NVIDIA GPUs (Triton).

The E-step's sequential core is 2T dependent (B, K) @ (K, K) steps. Under
`lax.scan` every step is one XLA while-loop iteration with its own kernel
launches, so per-step launch latency, not FLOPs or bytes, bounds it. Here
each recursion runs inside ONE launch:

  * The grid runs over blocks of ``block_b`` sequences only; a `fori_loop`
    over T runs inside the block. Hopper runs blocks in parallel and in no
    order, so nothing is carried from one grid step to the next.
  * alpha and beta stay in registers. A~ = exp(E[log A]) is loaded once per
    block.
  * The forward renormalizes PER SEQUENCE, EVERY step (numerics, not
    hardware): the stored alpha_hat_t sums to 1, so f32 only ever holds one
    step's decay. Anything laxer underflows within a few hundred steps at
    early-training parameters.
  * The backward fuses gamma and the summed pairwise marginals into the
    beta sweep. Each block writes its own (K, K) sum-of-xi partial and XLA
    sums the partials.

Two launches, not one: the backward reads alpha_hat written by other
threads of the forward, and only a kernel boundary orders those accesses.

Math (identical to messages/scan_fb.py::forward_backward, Rabiner scaling):

    alpha_hat_t = (alpha_hat_{t-1} @ A~) * lik_t / c_t
    braw_{t-1}  = A~ @ (lik_t * beta_t),  beta_{t-1} = braw_{t-1} / sum(.)
    n_t         = sum(alpha_hat_{t-1} * braw_{t-1})
    gamma_{t-1} = alpha_hat_{t-1} * braw_{t-1} / n_t
    sum xi      = A~ * sum_t g_t outer(alpha_hat_{t-1} / n_t, lik_t * beta_t)

with lik_t = exp(ll_t - max_k ll_tk) and g_t = w_{t-1} w_t the pair gate of
SVI's buffer discard.

Shapes are padded to what Triton's blocks need: K to a power of two >= 16
(padded states have zero initial and transition mass, so they carry no
probability), B to a multiple of ``block_b`` (padded rows have zero pair
gates and are sliced off, so they add nothing to any statistic).

Every dot names its precision (``precision``): on the Triton route
``lax.Precision.HIGHEST`` lowers to IEEE f32 FMA, while None, DEFAULT and
HIGH lower to TF32, whose 2^-11 rounding compounds along the chain.
``lax.DotAlgorithmPreset.TF32_TF32_F32_X3`` (tensor cores) measured no more
accurate and slower at K=64 on an H100 (5.07 vs 4.04 ms).

``interpret=True`` runs the same kernels in the Pallas interpreter (CPU
tests); without it, a backend other than CUDA cannot compile them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .scan_fb import FBResult

TINY = 1e-37  # per-sequence sum floor: a fully-underflowed step degrades to
# zero statistics instead of 0/0 NaN
PAD_LL = -1e30  # log-likelihood of padded states: exp(PAD_LL - max) == 0
# Sequences per program: 16 is the least the Sigma-xi dot takes (its
# contraction runs over the block's rows). Measured on an H100 at
# K=64/B=1024/T=1000, the recursion takes 4.04 ms at 16 rows and 8 warps,
# 4.74 ms at 4 warps, 5.71 ms at 16 warps, 5.76 ms at 32 rows (fewer
# programs than SMs either way: 64 and 32 on 132).
BLOCK_B = 16
NUM_WARPS = 8


def _lik(ll):
    """exp(ll - per-row max) and the max, for one (rows, Kp) step."""
    m = jnp.max(ll, axis=1)
    return jnp.exp(ll - m[:, None]), m


def _norm(x):
    """Per-row sums of x, floored at TINY, as a (rows, 1) column."""
    return jnp.maximum(jnp.sum(x, axis=1), TINY)[:, None]


def _fwd_kernel(pi_ref, A_ref, ll_ref, alpha_ref, logc_ref, *, T, precision):
    """Forward sweep of one block: writes alpha_hat (rows, T, Kp) and the
    per-step log scaling constants log c_t + shift_t (rows, T)."""
    A = A_ref[...]

    def emit(t, a, m):
        c = jnp.maximum(jnp.sum(a, axis=1), TINY)
        alpha = a / c[:, None]
        alpha_ref[:, t, :] = alpha
        logc_ref[:, t] = jnp.log(c) + m
        return alpha

    lik0, m0 = _lik(ll_ref[:, 0, :])
    alpha0 = emit(0, pi_ref[...] * lik0, m0)

    def step(t, alpha):
        lik, m = _lik(ll_ref[:, t, :])
        a = pl.dot(alpha, A, precision=precision) * lik
        return emit(t, a, m)

    lax.fori_loop(1, T, step, alpha0)


def _bwd_kernel(At_ref, ll_ref, alpha_ref, g_ref, gamma_ref, xi_ref, *, T,
                precision):
    """Backward sweep of one block: beta recursion fused with gamma and this
    block's partial sum of g_t outer(alpha_hat_{t-1} / n_t, lik_t beta_t)."""
    At = At_ref[...]
    a_last = alpha_ref[:, T - 1, :]
    gamma_ref[:, T - 1, :] = a_last / _norm(a_last)
    Kp = At.shape[0]

    def step(s, carry):
        beta, acc = carry
        t = T - 1 - s
        lik, _ = _lik(ll_ref[:, t, :])
        e = lik * beta
        braw = pl.dot(e, At, precision=precision)  # A~ @ e per row
        a_prev = alpha_ref[:, t - 1, :]
        prod = a_prev * braw
        n = _norm(prod)
        gamma_ref[:, t - 1, :] = prod / n
        wa = a_prev * (g_ref[:, t][:, None] / n)
        acc = acc + pl.dot(wa, e, trans_a=True, precision=precision)
        return braw / _norm(braw), acc

    beta0 = jnp.ones_like(a_last)
    acc0 = jnp.zeros((Kp, Kp), jnp.float32)
    _, acc = lax.fori_loop(0, T - 1, step, (beta0, acc0))
    xi_ref[...] = acc


def padded_shapes(B: int, K: int, block_b: int = BLOCK_B) -> tuple[int, int]:
    """(Bp, Kp): the batch rounded up to whole blocks, the state count to a
    power of two of at least 16 (the smallest dot Triton takes)."""
    Kp = max(16, pl.next_power_of_2(K))
    Bp = -(-B // block_b) * block_b
    return Bp, Kp


@functools.partial(
    jax.jit, static_argnames=("interpret", "block_b", "precision")
)
def pallas_forward_backward_batched(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,  # (B, T, K)
    weights: jax.Array | None = None,  # (B, T) kept-mask (SVI buffers)
    *,
    interpret: bool = False,
    block_b: int = BLOCK_B,
    precision=lax.Precision.HIGHEST,
) -> FBResult:
    """Batched forward-backward with the scan path's contract.

    Returns FBResult with a leading batch axis on gamma / log_z /
    init_stats / log_c, and trans_stats SUMMED over the batch, shape (K, K)
    (what every global update consumes).
    """
    B, T, K = log_lik.shape
    Bp, Kp = padded_shapes(B, K, block_b)
    nb = Bp // block_b

    ll = log_lik.astype(jnp.float32)
    if Kp != K:
        ll = jnp.pad(ll, ((0, 0), (0, 0), (0, Kp - K)), constant_values=PAD_LL)
    if Bp != B:
        ll = jnp.pad(ll, ((0, Bp - B), (0, 0), (0, 0)))
    A_tilde = jnp.exp(log_A).astype(jnp.float32)
    A_p = jnp.pad(A_tilde, ((0, Kp - K), (0, Kp - K)))
    pi_p = jnp.pad(jnp.exp(log_pi).astype(jnp.float32), (0, Kp - K))[None, :]

    w = (jnp.ones((B, T), jnp.float32) if weights is None
         else weights.astype(jnp.float32))
    gates = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.float32), w[:, :-1] * w[:, 1:]], axis=1
    )
    gates = jnp.pad(gates, ((0, Bp - B), (0, 0)))

    params = None if interpret else plgpu.CompilerParams(
        num_warps=NUM_WARPS, num_stages=1
    )
    full = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    rows3 = pl.BlockSpec((block_b, T, Kp), lambda i: (i, 0, 0))
    rows2 = pl.BlockSpec((block_b, T), lambda i: (i, 0))

    alpha, log_c = pl.pallas_call(
        functools.partial(_fwd_kernel, T=T, precision=precision),
        grid=(nb,),
        in_specs=[full((1, Kp)), full((Kp, Kp)), rows3],
        out_specs=[rows3, rows2],
        out_shape=[
            jax.ShapeDtypeStruct((Bp, T, Kp), jnp.float32),
            jax.ShapeDtypeStruct((Bp, T), jnp.float32),
        ],
        backend="triton",
        compiler_params=params,
        interpret=interpret,
        name="hmm_forward",
    )(pi_p, A_p, ll)

    gamma, xi = pl.pallas_call(
        functools.partial(_bwd_kernel, T=T, precision=precision),
        grid=(nb,),
        in_specs=[full((Kp, Kp)), rows3, rows3, rows2],
        out_specs=[rows3, pl.BlockSpec((None, Kp, Kp), lambda i: (i, 0, 0))],
        out_shape=[
            jax.ShapeDtypeStruct((Bp, T, Kp), jnp.float32),
            jax.ShapeDtypeStruct((nb, Kp, Kp), jnp.float32),
        ],
        backend="triton",
        compiler_params=params,
        interpret=interpret,
        name="hmm_backward",
    )(A_p.T, ll, alpha, gates)

    gamma = gamma[:B, :, :K]
    log_c = log_c[:B]
    trans_stats = A_tilde * jnp.sum(xi, axis=0)[:K, :K]
    return FBResult(
        gamma=gamma,
        log_z=jnp.sum(log_c, axis=-1),
        trans_stats=trans_stats,
        init_stats=gamma[:, 0] * w[:, :1],
        log_c=log_c,
    )
