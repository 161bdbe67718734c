"""Time-tiled forward-backward for very long single chains (BASELINE config 4).

Hybrid of scan_fb and assoc_fb (SURVEY.md §5 "long-context"): the chain is
cut into fixed-size time tiles; *within* a tile the per-step K x K matrices
are combined with `associative_scan` (log-depth, batched matmuls) while
a `lax.scan` carries the boundary messages *across* tiles. Peak memory is
O(block_size * K^2 + T * K) regardless of T, so K = 64, T = 100k chains run
with matmul-sized work per step instead of 100k sequential (1, K) matvecs.

Transitions are padded to a whole number of tiles with identity matrices
(exactly neutral for products and log-normalizers), so any T works.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .scan_fb import FBResult, _normalize_loglik
from .assoc_fb import _combine


class StreamStats(NamedTuple):
    """Reduced outputs of the streaming long-chain FB tiers."""

    log_z: jax.Array  # ()
    init_stats: jax.Array  # (K,) = gamma_0
    trans_stats: jax.Array  # (K, K) summed pairwise marginals
    acc: object  # stat_fn accumulator pytree (None if no stat_fn)
    z: object = None  # (T,) int32 argmax-gamma decode when the tier was
    #   asked to emit it (stream_fused.py emit_argmax); None otherwise


def _pad_count(n_trans: int, S: int) -> int:
    return (S - n_trans % S) % S


def forward_backward_blocked(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,
    weights: jax.Array | None = None,
    block_size: int = 256,
) -> FBResult:
    """Same contract as scan_fb.forward_backward; O(T/S) sequential depth."""
    T, K = log_lik.shape
    S = min(block_size, max(T - 1, 1))
    A_tilde = jnp.exp(log_A)
    lik, shifts = _normalize_loglik(log_lik)
    dtype = log_lik.dtype

    n_trans = T - 1
    pad = _pad_count(n_trans, S)
    n_blocks = (n_trans + pad) // S

    # Per-transition matrices M_t (t = 1..T-1), padded with identity.
    eye = jnp.eye(K, dtype=dtype)
    lik_tr = jnp.concatenate([lik[1:], jnp.ones((pad, K), dtype)], axis=0)
    valid = jnp.concatenate(
        [jnp.ones((n_trans,), bool), jnp.zeros((pad,), bool)], axis=0
    )
    M_all = jnp.where(
        valid[:, None, None],
        A_tilde[None, :, :] * lik_tr[:, None, :],
        eye[None, :, :],
    ).reshape(n_blocks, S, K, K)

    a0 = jnp.exp(log_pi) * lik[0]
    c0 = jnp.sum(a0)
    alpha0 = a0 / c0

    def fwd_block(a, M_blk):
        m0 = jnp.max(M_blk, axis=(-2, -1), keepdims=True)
        M_n = M_blk / m0
        s0 = jnp.log(m0[..., 0, 0])
        P, sP = lax.associative_scan(_combine, (M_n, s0))
        au = jnp.einsum("k,tkj->tj", a, P)  # (S, K)
        sums = jnp.sum(au, axis=-1)
        alphas = au / sums[:, None]
        cums = jnp.log(sums) + sP
        log_c = jnp.diff(jnp.concatenate([jnp.zeros((1,), dtype), cums]))
        return alphas[-1], (alphas, log_c)

    _, (alphas_blk, logc_blk) = lax.scan(fwd_block, alpha0, M_all)
    alpha = jnp.concatenate(
        [alpha0[None], alphas_blk.reshape(-1, K)[:n_trans]], axis=0
    )
    log_c = jnp.concatenate([jnp.log(c0)[None], logc_blk.reshape(-1)[:n_trans]]) + shifts
    log_z = jnp.sum(log_c)

    def bwd_block(carry, M_blk):
        b = carry
        m0 = jnp.max(M_blk, axis=(-2, -1), keepdims=True)
        M_n = M_blk / m0
        s0 = jnp.log(m0[..., 0, 0])
        # reversed-order suffix of transposes => S'_i = (M_i ... M_last)^T
        Sp, _ = lax.associative_scan(
            _combine, (jnp.swapaxes(M_n, -1, -2), s0), reverse=True
        )
        bu = jnp.einsum("tkj,k->tj", Sp, b)  # beta_{i-1} rows within block
        betas = bu / jnp.sum(bu, axis=-1, keepdims=True)
        return betas[0], betas

    _, betas_blk = lax.scan(
        bwd_block, jnp.ones((K,), dtype), M_all, reverse=True
    )
    # betas_blk[j, i] = beta at position (j*S + i) (transition index offset):
    # beta_{t-1} for transition t => rows cover positions 0..n_trans+pad-1;
    # beta_{T-1} = 1 is appended, padded tail dropped.
    beta = jnp.concatenate(
        [betas_blk.reshape(-1, K)[:n_trans], jnp.ones((1, K), dtype)], axis=0
    )

    g = alpha * beta
    gamma = g / jnp.sum(g, axis=-1, keepdims=True)

    if weights is None:
        w = jnp.ones((T,), dtype)
    else:
        w = weights.astype(dtype)

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


def _block_products(A_tilde, lik_tr, valid, n_blocks, S, chunk_blocks=64):
    """Per-block transfer-operator products Q_b = M_{bS+1} .. M_{(b+1)S}
    (row-vector convention: alpha @ Q advances a whole block), tree-reduced
    with per-level max renorm, streamed in chunks of blocks so no
    (T, K, K) array ever exists.

    The leaf level pairs factored matrices M = A~ * lik[None, :] DIRECTLY
    from the likelihood rows (one K^3 matmul per pair, no M
    materialization); identity padding (invalid transitions) is folded in
    via a select on the factored form's two likelihood rows, which is
    exact here because padding only ever trails the LAST real transition:
    a padded pair is (M, I) or (I, I), and (A~ * l1) @ I-with-l2=1 is
    wrong — so instead invalid leaves select the identity matrix
    explicitly. Dropped renorm scales cancel in the normalized boundary
    messages (the only consumer). Products run at full f32 (HIGHEST):
    they steer boundary SEEDS only, and a seed misalignment eps costs ~eps
    nats of log Z per block (analysis in forward_backward_blocked_twophase),
    but DEFAULT is TF32 on the GPU (eps ~ 5e-4 per product), which at
    T = 10^7 adds tens of nats for no measured gain.
    """
    K = A_tilde.shape[0]
    dtype = lik_tr.dtype
    eye = jnp.eye(K, dtype=dtype)
    prec = lax.Precision.HIGHEST

    tiny = jnp.finfo(dtype).tiny

    def mm(x, y):
        r = jnp.einsum("nij,njk->nik", x, y, precision=prec,
                       preferred_element_type=dtype)
        # tiny floor: a hard-zero likelihood row (-inf log_lik) can drive a
        # block product to all-zeros; 0/0 here would turn a clean -inf
        # log_z into NaN, while 0/tiny propagates zeros
        return r / jnp.maximum(jnp.max(r, axis=(1, 2), keepdims=True), tiny)

    def chunk_products(lik_blk, val_blk):
        # lik_blk (CB, S, K), val_blk (CB, S) -> (CB, K, K)
        CB = lik_blk.shape[0]
        l2 = lik_blk.reshape(CB * S // 2, 2, K)
        v2 = val_blk.reshape(CB * S // 2, 2)
        # leaf pair product in factored form, identity where invalid
        Ml = jnp.where(v2[:, 0, None, None], A_tilde[None] * l2[:, 0][:, None, :], eye[None])
        Mr = jnp.where(v2[:, 1, None, None], A_tilde[None] * l2[:, 1][:, None, :], eye[None])
        Q = mm(Ml, Mr)  # (CB*S/2, K, K)
        m = CB * S // 2
        while m > CB:
            Q = mm(Q[0::2], Q[1::2])
            m //= 2
        return Q  # (CB, K, K)

    if S == 1:
        def chunk_products(lik_blk, val_blk):  # noqa: F811 — S=1 degenerate
            return jnp.where(
                val_blk[:, 0, None, None],
                A_tilde[None] * lik_blk[:, 0][:, None, :],
                eye[None],
            )

    CB = min(chunk_blocks, n_blocks)
    while n_blocks % CB:
        CB -= 1
    lik_c = lik_tr.reshape(n_blocks // CB, CB, S, K)
    val_c = valid.reshape(n_blocks // CB, CB, S)
    _, Q = lax.scan(
        lambda c, xs: (c, chunk_products(*xs)), 0, (lik_c, val_c)
    )
    return Q.reshape(n_blocks, K, K)


def forward_backward_blocked_twophase(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,
    block_size: int = 256,
    stat_xs: jax.Array | None = None,
    stat_fn=None,
    stat_init=None,
    beta_end: jax.Array | None = None,
) -> StreamStats:
    """Two-phase streaming FB for very long single chains — the fast tier.

    Same contract and O(T K) memory as
    :func:`forward_backward_blocked_stream`, but restructured to kill that
    path's dominant cost: `lax.associative_scan` materializes full
    (S, K, K) prefix-product arrays at EVERY tree level (~2 log2(S)
    passes of S*K^2 floats per block, and it collapses beyond S=512). Here,
    the sequential-vs-parallel split follows messages/time_sharded.py's
    three-phase schedule, applied single-device at BLOCK granularity:

      1. per-block K x K transfer products Q_b, tree-REDUCED (products
         only, no prefixes: ~2 T K^2 floats of traffic total, in chunks);
      2. boundary recursions over blocks (2 sequential scans of n_blocks
         tiny steps): exact filtered alpha at every block start, exact
         beta seed at every block end;
      3. seeded VECTOR sweeps inside all blocks at once, vmapped ACROSS
         blocks: each in-block step is one (n_blocks, K) @ (K, K)
         matmul, so the sequential depth is S (not T) and the rows axis
         carries n_blocks sequences of work. Per-step log normalizers
         seeded by the TRUE filtered alpha reproduce the global scaling
         constants exactly (time_sharded.py's log_pi_loc identity), and
         the backward sweep fuses gamma, pairwise stats, and the
         emission-stat reduction exactly as the assoc tier does.

    Phase-1 products run at full f32: a boundary-seed misalignment eps
    costs ~eps nats of log Z per block (the seeded scan's normalizers
    telescope within a block); under x64 they are exact f64 and the f64
    oracle-parity suite pins the math.

    Per-step kept-masks are not supported (exact full-chain E-steps only,
    as for the assoc tier).

    beta_end: optional (K,) backward seed at the LAST time (default: the
    uninformative ones seed). Lets a time-sharded caller run this path
    per device tile with its right-neighbor's boundary message
    (messages/time_sharded.py::time_sharded_long_chain_stats); a scalar
    rescale of the seed is immaterial (every consumer renormalizes).
    """
    T, K = log_lik.shape
    dtype = log_lik.dtype
    lik, shifts = _normalize_loglik(log_lik)
    have_stats = stat_fn is not None
    if have_stats and stat_xs is None:
        raise ValueError("stat_fn requires stat_xs (the per-step operand)")

    if T == 1:
        v0 = jnp.exp(log_pi) * lik[0]
        c0 = jnp.sum(v0)
        g = v0 if beta_end is None else v0 * beta_end
        gamma0 = g / jnp.sum(g)
        acc = None
        if have_stats:
            acc = stat_fn(gamma0[None], stat_xs[:1])
            if stat_init is not None:
                acc = jax.tree.map(lambda a, z: a + z.astype(a.dtype), acc, stat_init)
        return StreamStats(
            log_z=jnp.log(c0) + jnp.sum(shifts),
            init_stats=gamma0,
            trans_stats=jnp.zeros((K, K), dtype),
            acc=acc,
        )

    # S must be a power of two: the chunked tree reduce pairs a FLAT stack
    # of per-block factors, which stays within block boundaries only while
    # every level's per-block count is even
    S = 1 << (min(block_size, T - 1).bit_length() - 1)
    A_tilde = jnp.exp(log_A).astype(dtype)
    n_trans = T - 1
    pad = _pad_count(n_trans, S)
    n_blocks = (n_trans + pad) // S

    lik_tr = jnp.concatenate([lik[1:], jnp.ones((pad, K), dtype)], axis=0)
    valid = jnp.concatenate(
        [jnp.ones((n_trans,), dtype), jnp.zeros((pad,), dtype)], axis=0
    )
    valid_b = jnp.concatenate(
        [jnp.ones((n_trans,), bool), jnp.zeros((pad,), bool)], axis=0
    )

    # ---- phase 1: block products (chunked tree reduce) ----
    Q = _block_products(
        A_tilde, lik_tr.reshape(n_blocks, S, K), valid_b.reshape(n_blocks, S),
        n_blocks, S,
    )

    # ---- phase 2: boundary recursions over blocks ----
    a0 = jnp.exp(log_pi).astype(dtype) * lik[0]
    c0 = jnp.sum(a0)
    alpha0 = a0 / c0

    def fwd_bound(a, Qb):
        an = a @ Qb
        an = an / jnp.sum(an)
        return an, a  # emit the seed at the block's START

    _, seeds_a = lax.scan(fwd_bound, alpha0, Q)  # (n_blocks, K)

    def bwd_bound(b, Qb):
        bn = Qb @ b
        bn = bn / jnp.sum(bn)
        return bn, b  # emit beta at the block's END

    b_seed = jnp.full((K,), 1.0 / K, dtype)
    if beta_end is not None:
        b_seed = beta_end / jnp.sum(beta_end)
    _, seeds_b = lax.scan(
        bwd_bound, b_seed, Q, reverse=True
    )  # (n_blocks, K) — beta at time (b+1)S, normalized

    # ---- phase 3: vmapped in-block sweeps (sequential depth S) ----
    lik_s = jnp.swapaxes(lik_tr.reshape(n_blocks, S, K), 0, 1)  # (S, nB, K)
    val_s = jnp.swapaxes(valid.reshape(n_blocks, S), 0, 1)  # (S, nB)

    def fwd_step(a, xs):
        l_t, v_t = xs
        au = (a @ A_tilde) * l_t
        c = jnp.sum(au, axis=-1)
        a_new = au / c[:, None]
        keep = v_t[:, None]
        a = keep * a_new + (1.0 - keep) * a
        return a, (a, jnp.where(v_t, jnp.log(c), 0.0))

    _, (alphas, log_cs) = lax.scan(fwd_step, seeds_a, (lik_s, val_s))
    # alphas (S, nB, K): alpha at time bS + s + 1
    log_z = jnp.log(c0) + jnp.sum(log_cs) + jnp.sum(shifts)

    if have_stats:
        target = n_blocks * S
        xs_p = stat_xs[1 : target + 1]
        if xs_p.shape[0] < target:
            pad_rows = jnp.zeros(
                (target - xs_p.shape[0],) + stat_xs.shape[1:], stat_xs.dtype
            )
            xs_p = jnp.concatenate([xs_p, pad_rows], axis=0)
        xs_s = jnp.swapaxes(
            xs_p.reshape((n_blocks, S) + stat_xs.shape[1:]), 0, 1
        )  # (S, nB, ...) aligned with times bS + s + 1
        out_sds = jax.eval_shape(
            stat_fn,
            jax.ShapeDtypeStruct((n_blocks, K), dtype),
            jax.ShapeDtypeStruct(xs_s.shape[1:], stat_xs.dtype),
        )
        acc0 = jax.tree.map(lambda z, o: jnp.asarray(z, o.dtype), stat_init, out_sds)
    else:
        xs_s = jnp.zeros((S, n_blocks, 0), dtype)
        acc0 = jnp.zeros((0,), dtype)

    # alpha at time bS + s (the xi left operand): alphas shifted one step,
    # closed by the block-start seeds
    a_prev = jnp.concatenate([seeds_a[None], alphas[:-1]], axis=0)

    def bwd_step(carry, xs):
        b, acc_tr, acc_st = carry  # b: beta at time bS + s + 1 (this step)
        l_t, v_t, al_t, ap_t, xsb = xs
        keep = v_t[:, None]

        if have_stats:
            g = al_t * b
            gamma = g / jnp.sum(g, axis=-1, keepdims=True)
            gamma = gamma * keep
            acc_st = jax.tree.map(jnp.add, acc_st, stat_fn(gamma, xsb))

        bl = l_t * b  # (nB, K)
        n = jnp.einsum("bk,bk->b", ap_t @ A_tilde, bl)
        aw = ap_t * (v_t / n)[:, None]
        acc_tr = acc_tr + A_tilde * jnp.einsum("bi,bj->ij", aw, bl)

        b_new = bl @ A_tilde.T
        b_new = b_new / jnp.sum(b_new, axis=-1, keepdims=True)
        b = keep * b_new + (1.0 - keep) * b
        return (b, acc_tr, acc_st), None

    (beta_first, trans_stats, acc), _ = lax.scan(
        bwd_step,
        (seeds_b, jnp.zeros((K, K), dtype), acc0),
        (lik_s, val_s, alphas, a_prev, xs_s),
        reverse=True,
    )
    # beta_first[b] = beta at time bS; block 0's row is beta at time 0
    g0 = alpha0 * beta_first[0]
    init_stats = g0 / jnp.sum(g0)
    if have_stats:
        acc = jax.tree.map(
            jnp.add, acc, stat_fn(init_stats[None], stat_xs[:1])
        )
    else:
        acc = None

    return StreamStats(
        log_z=log_z, init_stats=init_stats, trans_stats=trans_stats, acc=acc
    )


def forward_backward_blocked_stream(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,
    block_size: int = 256,
    stat_xs: jax.Array | None = None,
    stat_fn=None,
    stat_init=None,
) -> StreamStats:
    """Streaming blocked FB for very long single chains (T = millions).

    Same math as :func:`forward_backward_blocked`, but nothing of size
    T x K^2 or even T x K beyond the forward messages is ever materialized:
    the per-transition K x K matrices are built INSIDE each scan block from
    the likelihood slice, and the backward sweep reduces gamma blockwise
    into accumulators instead of emitting it. Peak memory is
    O(T K + S K^2); at K = 64 a T = 10M chain needs ~5 GB of HBM where
    `forward_backward_blocked` would need 164 GB for its M_all alone.

    stat_fn(gamma_blk (S, K), xs_blk) -> pytree is reduced (tree-summed)
    over all time steps with gamma zeroed outside the chain; use it for
    emission sufficient statistics. `stat_init` is the zero accumulator,
    `stat_xs` a (T, ...) per-step operand (e.g. observations), padded
    internally with zero rows. Per-step kept-masks (`weights`) are not
    supported here — this path is for exact full-chain E-steps.

    Per-block log-normalizer sums are emitted as scan outputs and reduced
    with one pairwise `jnp.sum` (not carried sequentially), so the f32
    log Z error does not random-walk over tens of thousands of blocks.
    """
    T, K = log_lik.shape
    dtype = log_lik.dtype
    lik, shifts = _normalize_loglik(log_lik)
    have_stats = stat_fn is not None
    if have_stats and stat_xs is None:
        raise ValueError("stat_fn requires stat_xs (the per-step operand)")

    if T == 1:
        v0 = jnp.exp(log_pi) * lik[0]
        c0 = jnp.sum(v0)
        gamma0 = v0 / c0
        acc = None
        if have_stats:
            acc = stat_fn(gamma0[None], stat_xs[:1])
            if stat_init is not None:
                acc = jax.tree.map(lambda a, z: a + z.astype(a.dtype), acc, stat_init)
        return StreamStats(
            log_z=jnp.log(c0) + jnp.sum(shifts),
            init_stats=gamma0,
            trans_stats=jnp.zeros((K, K), dtype),
            acc=acc,
        )

    S = min(block_size, T - 1)
    A_tilde = jnp.exp(log_A)
    eye = jnp.eye(K, dtype=dtype)
    n_trans = T - 1
    pad = _pad_count(n_trans, S)
    n_blocks = (n_trans + pad) // S

    lik_tr = jnp.concatenate([lik[1:], jnp.ones((pad, K), dtype)], axis=0)
    lik_tr = lik_tr.reshape(n_blocks, S, K)
    valid = jnp.concatenate(
        [jnp.ones((n_trans,), bool), jnp.zeros((pad,), bool)], axis=0
    ).reshape(n_blocks, S)

    def make_M(lik_blk, val):
        return jnp.where(
            val[:, None, None],
            A_tilde[None, :, :] * lik_blk[:, None, :],
            eye[None, :, :],
        )

    a0 = jnp.exp(log_pi) * lik[0]
    c0 = jnp.sum(a0)
    alpha0 = a0 / c0

    def fwd_block(a, xs):
        lik_blk, val = xs
        M_blk = make_M(lik_blk, val)
        m0 = jnp.max(M_blk, axis=(-2, -1), keepdims=True)
        M_n = M_blk / m0
        s0 = jnp.log(m0[..., 0, 0])
        P, sP = lax.associative_scan(_combine, (M_n, s0))
        au = jnp.einsum("k,tkj->tj", a, P)  # (S, K)
        sums = jnp.sum(au, axis=-1)
        alphas = au / sums[:, None]
        # sum of per-step log_c over the block = last cumulative value
        # (identity-padded steps contribute exactly 0)
        return alphas[-1], (alphas, jnp.log(sums[-1]) + sP[-1])

    _, (alphas_blk, logc_sums) = lax.scan(fwd_block, alpha0, (lik_tr, valid))
    log_z = jnp.log(c0) + jnp.sum(logc_sums) + jnp.sum(shifts)

    # alpha at time jS + i for rows (j, i): block j's row 0 is the LAST
    # alpha of block j-1 (alpha0 for j = 0), rows 1.. are block j's own.
    a_prev_last = jnp.concatenate([alpha0[None], alphas_blk[:-1, -1]], axis=0)

    if have_stats:
        target = n_blocks * S  # rows aligned with times jS + i
        if stat_xs.shape[0] >= target:
            xs_p = stat_xs[:target]
        else:
            pad_rows = jnp.zeros(
                (target - stat_xs.shape[0],) + stat_xs.shape[1:], stat_xs.dtype
            )
            xs_p = jnp.concatenate([stat_xs, pad_rows], axis=0)
        xs_blocks = xs_p.reshape((n_blocks, S) + stat_xs.shape[1:])
    else:
        xs_blocks = jnp.zeros((n_blocks, S, 0), dtype)

    if have_stats:
        # Promote the accumulator to the dtype stat_fn ACTUALLY produces
        # (gamma is built in the chain dtype, so e.g. an f64 chain with f32
        # params yields f64 stats). A carry whose input/output dtypes differ
        # is a trace-time scan error, and silently down-casting to
        # stat_init's dtype would forfeit the precision the chain runs at.
        out_sds = jax.eval_shape(
            stat_fn,
            jax.ShapeDtypeStruct((S, K), dtype),
            jax.ShapeDtypeStruct(xs_blocks.shape[1:], stat_xs.dtype),
        )
        acc0 = jax.tree.map(
            lambda z, o: jnp.asarray(z, o.dtype), stat_init, out_sds
        )
    else:
        acc0 = jnp.zeros((0,), dtype)

    def bwd_block(carry, xs):
        b_in, acc_tr, acc_stat = carry
        lik_blk, val, al_blk, a_prev, xsb = xs
        M_blk = make_M(lik_blk, val)
        m0 = jnp.max(M_blk, axis=(-2, -1), keepdims=True)
        M_n = M_blk / m0
        s0 = jnp.log(m0[..., 0, 0])
        Sp, _ = lax.associative_scan(
            _combine, (jnp.swapaxes(M_n, -1, -2), s0), reverse=True
        )
        bu = jnp.einsum("tkj,k->tj", Sp, b_in)  # beta at times jS + i
        betas = bu / jnp.sum(bu, axis=-1, keepdims=True)

        a_rows = jnp.concatenate([a_prev[None], al_blk[: S - 1]], axis=0)
        wv = val.astype(dtype)

        if have_stats:
            g = a_rows * betas
            gamma = g / jnp.sum(g, axis=-1, keepdims=True)
            gamma = gamma * wv[:, None]
            acc_stat = jax.tree.map(
                jnp.add, acc_stat, stat_fn(gamma, xsb)
            )

        # pairwise-marginal sums for transitions t = 1 + jS + i:
        # beta_t rows are this block's betas shifted by one, closed by b_in
        beta_next = jnp.concatenate([betas[1:], b_in[None]], axis=0)
        bl = lik_blk * beta_next
        n = jnp.einsum("tk,tk->t", a_rows @ A_tilde, bl)
        alpha_w = a_rows * (wv / n)[:, None]
        acc_tr = acc_tr + A_tilde * (alpha_w.T @ bl)
        return (betas[0], acc_tr, acc_stat), None

    (b0, trans_stats, acc), _ = lax.scan(
        bwd_block,
        (jnp.ones((K,), dtype), jnp.zeros((K, K), dtype), acc0),
        (lik_tr, valid, alphas_blk, a_prev_last, xs_blocks),
        reverse=True,
    )

    g0 = alpha0 * b0
    init_stats = g0 / jnp.sum(g0)

    if have_stats:
        # time T-1 (beta = 1) is covered by no block's gamma rows
        gamma_last = alphas_blk.reshape(-1, K)[n_trans - 1]
        acc = jax.tree.map(
            jnp.add, acc, stat_fn(gamma_last[None], stat_xs[T - 1 :])
        )
    else:
        acc = None

    return StreamStats(
        log_z=log_z, init_stats=init_stats, trans_stats=trans_stats, acc=acc
    )
