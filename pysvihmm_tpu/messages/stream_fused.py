"""Likelihood-fused streaming two-phase FB — the T≈10^8-on-one-card tier.

The two-phase streaming path (messages/blocked.py::
forward_backward_blocked_twophase) is exact and fast but takes the full
(T, K) expected-log-likelihood array as INPUT and re-reads it in all three
phases — ~3·T·K floats of device-memory traffic and a (T, K)-sized
residency. This module removes that array entirely: likelihoods are
computed per CHUNK from the raw observations (T × D floats, 8× smaller at
K=64/D=8) inside each phase, as one big matmul per chunk that stays OFF
the sequential chain.

Memory tiers (K = 64, f32):

* observations:      T·D floats        (the only full-T operand)
* phase-3 chunk lik: T·K/chunks floats (transient, per outer scan step)
* alphas:            T·K floats stored (``store_alphas=True``), or
                     T·K/chunks transient + chunks·(T/S)·K checkpoints
                     under REMATERIALIZATION (``store_alphas=False``): the
                     backward pass recomputes each chunk's filtered
                     messages from its checkpoint — one extra vector sweep
                     of FLOPs for an HBM ceiling set by the observations,
                     not the messages. T = 100M Gaussian chains (3.2 GB
                     obs at D=8) and T = 250M multinomial chains (1 GB
                     int32 tokens — the reference paper's chromatin
                     regime, Foti et al. 2014 §4 / SURVEY.md:284) fit one
                     chip.

The schedule is otherwise identical to the two-phase tier (same seeds,
same renorm algebra, f64-parity-tested against it and the scan oracle):

1. per-block K×K transfer products, tree-reduced in chunks, likelihood
   rows built in-chunk (leaf factors A~·diag(lik) never materialized);
2. boundary recursions over blocks (exact alpha seed at every block
   start, beta seed at every block end);
3. chunked, seeded vector sweeps vmapped across blocks: each outer step
   computes its chunk's likelihoods with one batched matmul, then the
   inner scan advances all blocks one time step per iteration.

``emit_argmax=True`` additionally streams the posterior-marginal decode
argmax_k gamma_tk out of the backward sweep (int32, T·4 bytes — the only
per-step output) — the long-chain segmentation deliverable the reference
reaches via argmax-gamma decode (``hmmbase`` decode, SURVEY.md:140) but
whose gamma array cannot be materialized at this scale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .blocked import StreamStats, _pad_count


def _lik_factory(ell_fn, dtype):
    """(rows (..., N, obs-dims) -> (lik (..., N, K) in [0,1], shifts))."""

    def lik_fn(rows):
        ll = ell_fn(rows)
        sh = lax.stop_gradient(jnp.max(ll, axis=-1))
        return jnp.exp(ll - sh[..., None]).astype(dtype), sh.astype(dtype)

    return lik_fn


def _block_products_fused(
    A_tilde, obs_blocks, valid, n_blocks, S, lik_fn, chunk_blocks=None,
    time_minor=False,
):
    """Per-block transfer products Q_b with in-chunk likelihoods.

    Same tree-reduce as blocked.py::_block_products (renormalized each
    level, tiny-floored, identity where invalid, full-f32 matmuls), but the likelihood rows are computed from the observation
    chunk right here, so no (T, K) array feeds this phase. Per-row max
    shifts are dropped entirely: every consumer of Q renormalizes.

    time_minor: obs_blocks arrives (D, n_blocks, S) (feature-major — see
    forward_backward_fused_twophase); chunks are transposed to rows
    transiently.
    """
    K = A_tilde.shape[0]
    dtype = A_tilde.dtype
    eye = jnp.eye(K, dtype=dtype)
    prec = lax.Precision.HIGHEST  # DEFAULT is TF32 on the GPU
    tiny = jnp.finfo(dtype).tiny
    tail = (obs_blocks.shape[0],) if time_minor else obs_blocks.shape[2:]

    def mm(x, y):
        r = jnp.einsum("nij,njk->nik", x, y, precision=prec,
                       preferred_element_type=dtype)
        return r / jnp.maximum(jnp.max(r, axis=(1, 2), keepdims=True), tiny)

    if chunk_blocks is None:
        # cap the leaf level's (CB*S/2, K, K) materialization at ~128 MB
        # f32 regardless of block size (large-S configs would otherwise
        # stage multi-GB level-0 products per chunk)
        K2 = K * K * jnp.dtype(dtype).itemsize
        chunk_blocks = max(1, (128 << 20) // max(S // 2, 1) // K2)
    CB = min(chunk_blocks, n_blocks)
    while n_blocks % CB:
        CB -= 1

    def chunk_products(o_blk, val_blk):
        # o_blk (CB, S, ...obs) or (D, CB, S) time-minor -> (CB, K, K)
        if time_minor:
            o_blk = jnp.transpose(o_blk, (1, 2, 0))  # (CB, S, D) transient
        lik_blk, _ = lik_fn(o_blk.reshape((CB * S,) + tail))
        if S == 1:
            return jnp.where(
                val_blk[:, 0, None, None],
                A_tilde[None] * lik_blk[:, None, :],
                eye[None],
            )
        l2 = lik_blk.reshape(CB * S // 2, 2, K)
        v2 = val_blk.reshape(CB * S // 2, 2)
        Ml = jnp.where(
            v2[:, 0, None, None], A_tilde[None] * l2[:, 0][:, None, :], eye[None]
        )
        Mr = jnp.where(
            v2[:, 1, None, None], A_tilde[None] * l2[:, 1][:, None, :], eye[None]
        )
        Q = mm(Ml, Mr)
        m = CB * S // 2
        while m > CB:
            Q = mm(Q[0::2], Q[1::2])
            m //= 2
        return Q

    if time_minor:
        # (D, n_blocks, S) -> (n_chunks, D, CB, S): scan axis leads, time
        # stays minor in the full-size array
        obs_c = jnp.swapaxes(
            obs_blocks.reshape(tail + (n_blocks // CB, CB * S)), 0, 1
        ).reshape((n_blocks // CB,) + tail + (CB, S))
    else:
        obs_c = obs_blocks.reshape((n_blocks // CB, CB, S) + tail)
    val_c = valid.reshape(n_blocks // CB, CB, S)
    _, Q = lax.scan(lambda c, xs: (c, chunk_products(*xs)), 0, (obs_c, val_c))
    return Q.reshape(n_blocks, K, K)


def forward_backward_fused_twophase(
    log_pi: jax.Array,
    log_A: jax.Array,
    obs: jax.Array,  # (T, ...) raw observations — floats or int tokens
    ell_fn,  # rows (..., N, obs-dims) -> expected log-lik (..., N, K)
    block_size: int = 1024,
    chunks: int = 8,
    store_alphas: bool | None = None,
    stat_xs: jax.Array | None = None,  # defaults to ``obs``
    stat_fn=None,
    stat_init=None,
    beta_end: jax.Array | None = None,
    emit_argmax: bool = False,
    time_minor: bool = False,
) -> StreamStats:
    """Exact streaming E-step for ONE long chain, likelihoods fused.

    Contract of blocked.py::forward_backward_blocked_twophase with the
    (T, K) log-likelihood INPUT replaced by (raw observations, ell_fn):
    returns the same reduced StreamStats (log_z / init / trans / acc),
    plus the full argmax-gamma decode in ``.z`` when ``emit_argmax``.

    ell_fn must map over arbitrary leading axes (the emission families'
    ``expected_log_likelihood`` and feature-matmul forms both do) and is
    invoked once per chunk in each phase — likelihood FLOPs are paid ~3×,
    HBM likelihood traffic ~0×.

    chunks: outer phase-3 chunking of the in-block time axis (clamped to
    divide the block size). Governs the transient likelihood/alpha
    footprint T·K/chunks and, under remat, the checkpoint count.
    store_alphas: True stores all (T, K) filtered messages between the
    sweeps (fastest while they fit); False rematerializes each chunk's
    alphas in the backward pass from chunks·(T/S)·K checkpoints. Default
    (None): store while alphas stay under ~2 GB f32.

    stat_fn(gamma (n_blocks, K), rows) is reduced over all time steps,
    with ``stat_xs`` rows as operand (default: the observations — the
    emission-stats case, where sharing the operand also shares its memory
    reads with the likelihood computation). Per-step kept-masks are not
    supported (exact full-chain E-steps only).

    time_minor=True: ``obs`` arrives FEATURE-MAJOR as (D, T), with time
    the minor dimension of every full-T array in this function (whether
    the GPU needs this layout is ROADMAP Queue 3's question). ell_fn/stat_fn still
    receive standard (N, D) rows (chunks are transposed transiently,
    O(T/chunks) at a time); stat_xs must be None in this mode.
    """
    tm = time_minor and obs.ndim >= 2
    if tm:
        if stat_xs is not None:
            raise ValueError("time_minor supports stat_xs=None (obs) only")
        T = obs.shape[-1]
        tail = (obs.shape[0],)
    else:
        T = obs.shape[0]
        tail = obs.shape[1:]
    probe = jax.eval_shape(
        ell_fn, jax.ShapeDtypeStruct((1,) + tail, obs.dtype)
    )
    K = probe.shape[-1]
    dtype = probe.dtype
    lik_fn = _lik_factory(ell_fn, dtype)
    have_stats = stat_fn is not None
    if stat_xs is None:
        stat_xs = obs
    if store_alphas is None:
        store_alphas = T * K * 4 <= 2 << 30

    rows0 = obs[:, :1].T if tm else obs[:1]  # the t=0 observation row

    if T == 1:
        lik0, sh0 = lik_fn(rows0)
        v0 = jnp.exp(log_pi).astype(dtype) * lik0[0]
        c0 = jnp.sum(v0)
        g = v0 if beta_end is None else v0 * beta_end
        gamma0 = g / jnp.sum(g)
        acc = None
        if have_stats:
            acc = stat_fn(gamma0[None], rows0 if tm else stat_xs[:1])
            if stat_init is not None:
                acc = jax.tree.map(
                    lambda a, z: a + z.astype(a.dtype), acc, stat_init
                )
        return StreamStats(
            log_z=jnp.log(c0) + sh0[0],
            init_stats=gamma0,
            trans_stats=jnp.zeros((K, K), dtype),
            acc=acc,
            z=jnp.argmax(gamma0)[None].astype(jnp.int32) if emit_argmax else None,
        )

    # power-of-two S for the tree reduce; C divides S
    S = 1 << (min(block_size, T - 1).bit_length() - 1)
    C = min(chunks, S)
    while S % C:
        C -= 1
    S2 = S // C
    A_tilde = jnp.exp(log_A).astype(dtype)
    n_trans = T - 1
    pad = _pad_count(n_trans, S)
    n_blocks = (n_trans + pad) // S

    # observation rows for times bS + s + 1, zero-padded to a whole grid
    # (padded rows produce finite garbage likelihoods that every consumer
    # gates out via the valid mask, exactly as the non-fused tiers pad
    # likelihoods with ones). time_minor keeps time the MINOR axis of
    # every full-T array.
    if tm:
        obs_tr = jnp.concatenate(
            [obs[:, 1:], jnp.zeros(tail + (pad,), obs.dtype)], axis=1
        )
        obs_blocks = obs_tr.reshape(tail + (n_blocks, S))
    else:
        obs_tr = jnp.concatenate(
            [obs[1:], jnp.zeros((pad,) + tail, obs.dtype)], axis=0
        )
        obs_blocks = obs_tr.reshape((n_blocks, S) + tail)
    valid = jnp.concatenate(
        [jnp.ones((n_trans,), dtype), jnp.zeros((pad,), dtype)], axis=0
    )
    valid_b = jnp.concatenate(
        [jnp.ones((n_trans,), bool), jnp.zeros((pad,), bool)], axis=0
    )

    # ---- phase 1: block products, likelihoods built in-chunk ----
    Q = _block_products_fused(
        A_tilde,
        obs_blocks,
        valid_b.reshape(n_blocks, S),
        n_blocks,
        S,
        lik_fn,
        time_minor=tm,
    )

    # ---- phase 2: boundary recursions over blocks ----
    lik0, sh0 = lik_fn(rows0)
    a0 = jnp.exp(log_pi).astype(dtype) * lik0[0]
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
    _, seeds_b = lax.scan(bwd_bound, b_seed, Q, reverse=True)

    # ---- phase 3 operands: (C, S2, n_blocks, ...) chunked time-major,
    # or (C, S2, D, n_blocks) under time_minor (n_blocks stays minor) ----
    def chunked(x, x_tail):
        xs = jnp.swapaxes(x.reshape((n_blocks, S) + x_tail), 0, 1)
        return xs.reshape((C, S2, n_blocks) + x_tail)

    if tm:
        obs_s = jnp.transpose(
            obs_blocks.reshape(tail + (n_blocks, C, S2)), (2, 3, 0, 1)
        )  # (C, S2, D, n_blocks)
    else:
        obs_s = chunked(obs_tr, tail)
    val_s = chunked(valid, ())
    if have_stats and (stat_xs is not obs):
        xs_tail = stat_xs.shape[1:]
        xs_p = stat_xs[1 : n_blocks * S + 1]
        if xs_p.shape[0] < n_blocks * S:
            xs_p = jnp.concatenate(
                [
                    xs_p,
                    jnp.zeros(
                        (n_blocks * S - xs_p.shape[0],) + xs_tail, stat_xs.dtype
                    ),
                ],
                axis=0,
            )
        xtra_s = chunked(xs_p, xs_tail)
    else:
        xtra_s = obs_s  # same traced array: scan slices alias, no copy

    # ---- phase 3 forward: chunked seeded sweeps, vmapped across blocks ----
    def fwd_step(a, xs2):
        l_t, sh_t, v_t = xs2
        au = (a @ A_tilde) * l_t
        c = jnp.sum(au, axis=-1)
        a_new = au / c[:, None]
        keep = v_t[:, None]
        a = keep * a_new + (1.0 - keep) * a
        return a, (a, jnp.sum(jnp.where(v_t > 0, jnp.log(c) + sh_t, 0.0)))

    # time_minor chunks arrive (S2, D, nB): transpose to standard rows
    # transiently (O(T/chunks) live at once)
    chunk_rows = (lambda o: jnp.transpose(o, (0, 2, 1))) if tm else (lambda o: o)

    def fwd_chunk(a, xs):
        o_c, v_c = xs
        ck = a  # alpha checkpoint at this chunk's start (per block)
        lik_c, sh_c = lik_fn(chunk_rows(o_c))  # ONE batched matmul, off the chain
        a, (al_c, logc_c) = lax.scan(fwd_step, a, (lik_c, sh_c, v_c))
        ys = (ck, jnp.sum(logc_c))
        return a, ys + (al_c,) if store_alphas else ys

    if store_alphas:
        _, (ckpts, logc_chunks, alphas_all) = lax.scan(
            fwd_chunk, seeds_a, (obs_s, val_s)
        )
    else:
        _, (ckpts, logc_chunks) = lax.scan(fwd_chunk, seeds_a, (obs_s, val_s))
    log_z = jnp.log(c0) + sh0[0] + jnp.sum(logc_chunks)

    # ---- phase 3 backward: gamma/stats/decode fused into the sweep ----
    if have_stats:
        row_shape = (n_blocks,) + tail if tm else xtra_s.shape[2:]
        out_sds = jax.eval_shape(
            stat_fn,
            jax.ShapeDtypeStruct((n_blocks, K), dtype),
            jax.ShapeDtypeStruct(row_shape, stat_xs.dtype),
        )
        acc0 = jax.tree.map(
            lambda z, o: jnp.asarray(z, o.dtype), stat_init, out_sds
        )
    else:
        acc0 = jnp.zeros((0,), dtype)

    def bwd_step(carry, xs2):
        b, acc_tr, acc_st = carry
        l_t, v_t, al_t, ap_t, xsb = xs2
        keep = v_t[:, None]
        z_t = jnp.zeros((), jnp.int32)
        if have_stats or emit_argmax:
            g = al_t * b
            gamma = g / jnp.sum(g, axis=-1, keepdims=True)
            if emit_argmax:
                z_t = jnp.argmax(gamma, axis=-1).astype(jnp.int32)
            if have_stats:
                acc_st = jax.tree.map(
                    jnp.add, acc_st, stat_fn(gamma * keep, xsb)
                )
        bl = l_t * b
        n = jnp.einsum("bk,bk->b", ap_t @ A_tilde, bl)
        aw = ap_t * (v_t / n)[:, None]
        acc_tr = acc_tr + A_tilde * jnp.einsum("bi,bj->ij", aw, bl)
        b_new = bl @ A_tilde.T
        b_new = b_new / jnp.sum(b_new, axis=-1, keepdims=True)
        b = keep * b_new + (1.0 - keep) * b
        return (b, acc_tr, acc_st), z_t

    def re_step(a, xs2):
        l_t, v_t = xs2
        au = (a @ A_tilde) * l_t
        a_new = au / jnp.sum(au, axis=-1, keepdims=True)
        keep = v_t[:, None]
        return keep * a_new + (1.0 - keep) * a, None

    def re_step_emit(a, xs2):
        a, _ = re_step(a, xs2)
        return a, a

    def bwd_chunk(carry, xs):
        if store_alphas:
            ck, al_c, o_c, v_c, x_c = xs
        else:
            ck, o_c, v_c, x_c = xs
        rows = chunk_rows(o_c)
        x_c = rows if tm else x_c  # stats read the same transposed rows
        lik_c, _ = lik_fn(rows)  # shifts cancel in every backward consumer
        if not store_alphas:
            # rematerialize this chunk's filtered messages from the
            # checkpoint — the extra vector sweep that buys the O(T/chunks)
            # alpha footprint
            _, al_c = lax.scan(re_step_emit, ck, (lik_c, v_c))
        ap_c = jnp.concatenate([ck[None], al_c[:-1]], axis=0)
        carry, z_c = lax.scan(
            bwd_step, carry, (lik_c, v_c, al_c, ap_c, x_c), reverse=True
        )
        return carry, z_c

    bwd_xs = (
        (ckpts, alphas_all, obs_s, val_s, xtra_s)
        if store_alphas
        else (ckpts, obs_s, val_s, xtra_s)
    )
    (beta_first, trans_stats, acc), z_all = lax.scan(
        bwd_chunk,
        (seeds_b, jnp.zeros((K, K), dtype), acc0),
        bwd_xs,
        reverse=True,
    )

    g0 = alpha0 * beta_first[0]
    init_stats = g0 / jnp.sum(g0)
    if have_stats:
        acc = jax.tree.map(
            jnp.add,
            acc,
            stat_fn(init_stats[None], rows0 if tm else stat_xs[:1]),
        )
    else:
        acc = None

    z = None
    if emit_argmax:
        # z_all (C, S2, n_blocks) holds times b*S + c*S2 + s2 + 1
        z_flat = jnp.transpose(z_all, (2, 0, 1)).reshape(n_blocks * S)
        z = jnp.concatenate(
            [jnp.argmax(init_stats)[None].astype(jnp.int32), z_flat[:n_trans]]
        )

    return StreamStats(
        log_z=log_z,
        init_stats=init_stats,
        trans_stats=trans_stats,
        acc=acc,
        z=z,
    )
