"""Exact forward-backward with the TIME axis sharded over a device mesh —
the framework's context-parallelism analog.

The reference scales long chains only *algorithmically* (buffered subchain
minibatching — SURVEY.md §2.4 "sequence parallelism" row); for exact
full-chain smoothing at T = 100k+ it would run a single sequential Cython
loop. Here the chain is cut into D contiguous tiles, one per device on a
``time`` mesh axis, and smoothing is exact via a three-phase schedule:

1. **Local tile products** (batched matmuls, no sequential chain): each
   device forms its per-step transfer matrices S_t = A~ diag(lik_t) and
   tree-reduces them (log-depth, renormalized each level) into one K x K
   tile operator Q_d. Row-vector convention: alpha_t ∝ alpha_{t-1} @ S_t,
   so Q_d = S_{dC} @ ... @ S_{(d+1)C-1} composes the whole tile.
2. **Boundary exchange** (tiny collective): ``all_gather`` of the D tile
   operators (D * K * K floats); every device then replicates the D-step
   boundary recursions a_d = normalize(a_{d-1} @ Q_d) (filtered alpha at
   each tile's LAST step, seeded by pi~ through tile 0's special first
   factor diag(lik_0)) and b_d = normalize(Q_{d+1} @ b_{d+1}) (beta at
   each tile's last step, seeded with ones at the right edge).
3. **Seeded local sweeps** (sequential depth T/D instead of T): each tile
   runs the standard normalized scans with its boundary messages as seeds
   — log_pi := log(a_in @ A~) reproduces the global per-step scaling
   constants c_t EXACTLY (a_in is the true normalized filtered marginal),
   so gamma, trans_stats, log_c and log Z all match the single-device
   scan bit-for-tolerance. Cross-tile pairwise stats need no extra
   communication: the xi for the boundary transition into tile d only
   involves a_in[d-1] (already replicated), the tile's first likelihood
   row, and its first beta.

Per-step weights (SVI kept-masks) are supported the same way scan_fb
supports them: weights gate init/trans stats only.

Two entry points: :func:`time_sharded_forward_backward` for one (T, K)
chain on a 1-D ``time`` mesh, and
:func:`time_sharded_forward_backward_batched` for a (B, T, K) batch of
long chains on a 2-D (``data``, ``time``) mesh — batch data-parallelism
and exact in-chain time-parallelism composed in one shard_map.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .scan_fb import FBResult, _normalize_loglik, backward, forward_with_logc


def _tree_product(S: jax.Array) -> jax.Array:
    """Left-to-right product of a stack of matrices, log-depth.

    S: (n, K, K) with product order S[0] @ S[1] @ ... @ S[n-1]. Each level
    is ONE batched matmul and is renormalized by its max to
    keep the geometric decay of sub-stochastic transfer products away from
    f32 underflow; the dropped scales cancel in the normalized boundary
    messages. Identity padding makes any n exact.
    """
    n, K = S.shape[0], S.shape[1]
    p2 = 1 << max(n - 1, 0).bit_length()
    if p2 != n:
        eye = jnp.broadcast_to(jnp.eye(K, dtype=S.dtype), (p2 - n, K, K))
        S = jnp.concatenate([S, eye], axis=0)
    tiny = jnp.finfo(S.dtype).tiny
    while S.shape[0] > 1:
        S = jnp.einsum(
            "nij,njk->nik",
            S[0::2],
            S[1::2],
            preferred_element_type=S.dtype,
        )
        # tiny floor keeps an underflowed-to-zero product propagating
        # zeros (clean -inf log_z) instead of 0/0 NaNs
        S = S / jnp.maximum(jnp.max(S, axis=(1, 2), keepdims=True), tiny)
    return S[0]


def _chain_tile_fb(log_pi, log_A, ll, w, idx, w_prev, D, axis):
    """Per-chain local tile of the three-phase schedule (see module doc).

    ll: (C, K) this device's tile of ONE chain's log-likelihoods; w (C,)
    kept-mask; idx this device's index on the time axis; w_prev the LEFT
    neighbor's final kept-mask value. Collectives run over ``axis``.
    Returns per-tile (gamma, log_c, trans_partial, init_partial, log_z_part)
    where the partials still need a psum over ``axis``.
    """
    K = log_A.shape[0]
    A_tilde = jnp.exp(log_A)
    lik, _ = _normalize_loglik(ll)

    # --- phase 1: tile operator (batched, no chain) ---
    S = A_tilde[None, :, :] * lik[:, None, :]  # S_t = A~ diag(lik_t)
    # tile 0's first factor is diag(lik_0): alpha_0 ∝ pi~ @ diag(lik_0)
    first = jnp.where(idx == 0, jnp.eye(K, dtype=lik.dtype) * lik[0][None, :], S[0])
    S = jnp.concatenate([first[None], S[1:]], axis=0)
    Q = _tree_product(S)

    # --- phase 2: boundary recursions on gathered tile operators ---
    Qg = lax.all_gather(Q, axis)  # (D, K, K), tiny
    a = jnp.exp(log_pi)
    a_last = []  # a_last[d] = normalized filtered alpha at tile d's last step
    for d in range(D):
        a = a @ Qg[d]
        a = a / jnp.sum(a)
        a_last.append(a)
    a_last = jnp.stack(a_last)  # (D, K)
    b = jnp.full((K,), 1.0 / K, lik.dtype)
    b_last = [b]  # beta at each tile's last step, built right-to-left
    for d in range(D - 1, 0, -1):
        b = Qg[d] @ b
        b = b / jnp.sum(b)
        b_last.append(b)
    b_last = jnp.stack(b_last[::-1])  # (D, K), indexed by tile

    # --- phase 3: seeded local sweeps (sequential depth T/D) ---
    a_in = jnp.take(a_last, jnp.maximum(idx - 1, 0), axis=0)  # alpha_{t0-1}
    log_pi_loc = jnp.where(
        idx == 0, log_pi, jnp.log(jnp.maximum(a_in @ A_tilde, 1e-38))
    )
    alpha, _, log_c = forward_with_logc(log_pi_loc, log_A, ll)
    beta = backward(log_A, ll, beta_last=jnp.take(b_last, idx, axis=0))

    g = alpha * beta
    gamma = g / jnp.sum(g, axis=-1, keepdims=True)

    # internal transitions (local matmul trick, as scan_fb)
    bl = lik[1:] * beta[1:]
    n = jnp.einsum("tk,tk->t", alpha[:-1] @ A_tilde, bl)
    w_pair = w[:-1] * w[1:]
    alpha_w = alpha[:-1] * (w_pair / n)[:, None]
    trans_partial = A_tilde * (alpha_w.T @ bl)
    # boundary transition INTO this tile (t = t0-1 -> t0), devices d>0.
    # Needs only a_in (replicated chain), our first lik row and beta.
    blb = lik[0] * beta[0]
    xi_b = A_tilde * jnp.outer(a_in, blb)
    xi_b = xi_b / jnp.sum(xi_b)
    gate = jnp.where(idx == 0, 0.0, w_prev * w[0])
    trans_partial = trans_partial + gate * xi_b

    init_partial = jnp.where(idx == 0, w[0] * gamma[0], jnp.zeros((K,), lik.dtype))
    return gamma, log_c, trans_partial, init_partial, jnp.sum(log_c)


def time_sharded_forward_backward(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,
    mesh: Mesh,
    axis: str = "time",
    weights: jax.Array | None = None,
) -> FBResult:
    """Exact FBResult for one (T, K) chain, T sharded over ``mesh[axis]``.

    Same contract as ``scan_fb.forward_backward``; gamma and log_c come
    back sharded over time, scalars/stats replicated. The time-axis size
    must divide T. Device-count-invariant up to f32 roundoff (tested
    against the single-device scan on a virtual 8-device mesh).
    """
    T, K = log_lik.shape
    D = mesh.shape[axis]
    if T % D != 0:
        raise ValueError(f"T={T} must be divisible by time-axis size {D}")

    spec_t = P(axis)
    spec_tk = P(axis, None)
    w_arg = weights if weights is not None else jnp.ones((T,), log_lik.dtype)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), spec_tk, spec_t),
        out_specs=(spec_tk, P(), P(), P(), spec_t),
        check_vma=False,
    )
    def fb(log_pi, log_A, ll, w):
        idx = lax.axis_index(axis)
        w_prev = lax.ppermute(w[-1], axis, [(i, (i + 1) % D) for i in range(D)])
        gamma, log_c, trans_p, init_p, log_z_p = _chain_tile_fb(
            log_pi, log_A, ll, w, idx, w_prev, D, axis
        )
        return (
            gamma,
            lax.psum(log_z_p, axis),
            lax.psum(trans_p, axis),
            lax.psum(init_p, axis),
            log_c,
        )

    gamma, log_z, trans_stats, init_stats, log_c = fb(log_pi, log_A, log_lik, w_arg)
    return FBResult(
        gamma=gamma,
        log_z=log_z,
        trans_stats=trans_stats,
        init_stats=init_stats,
        log_c=log_c,
    )


def time_sharded_long_chain_stats(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,  # (T, K) — gets time-sharded inside
    mesh: Mesh,
    axis: str = "time",
    block_size: int = 256,
    stat_xs: jax.Array | None = None,
    stat_fn=None,
    stat_init=None,
):
    """Streaming long-chain E-step with the TIME axis sharded over a mesh —
    the multi-chip route to the reference paper's T≈250M regime.

    One chip's HBM bounds the single-device two-phase tier at T ~ 15M
    (3 T K floats); this composes the same three-phase schedule ACROSS
    devices: per-device tile transfer products (chunked tree reduce, no
    (C, K, K) materialization), ONE tiny `all_gather` of the D tile
    operators, replicated boundary recursions, then each device runs
    :func:`~pysvihmm_tpu.messages.blocked.forward_backward_blocked_twophase`
    on its own tile seeded by its neighbors' boundary messages (log_pi :=
    log(a_in @ A~) reproduces the global per-step scaling constants
    exactly — the module's phase-3 identity; beta_end seeds the backward).
    Cross-tile pairwise stats need no extra communication (the boundary
    xi uses only replicated a_in + the tile's first likelihood row and
    beta). Returns a :class:`~pysvihmm_tpu.messages.blocked.StreamStats`
    with log_z / trans / acc psum-reduced (replicated) and init_stats =
    gamma_0 from the first tile. Exact: matches the single-device scan to
    float tolerance (tests/test_longchain.py::TestShardedStream).
    """
    from .blocked import (
        StreamStats,
        _block_products,
        _pad_count,
        forward_backward_blocked_twophase,
    )

    T, K = log_lik.shape
    D = mesh.shape[axis]
    if T % D != 0:
        raise ValueError(f"T={T} must be divisible by time-axis size {D}")
    C = T // D
    have_stats = stat_fn is not None
    if have_stats and stat_xs is None:
        raise ValueError("stat_fn requires stat_xs")
    xs_arg = stat_xs if have_stats else jnp.zeros((T, 0), log_lik.dtype)

    spec_tk = P(axis, None)
    spec_t = P(axis) if (have_stats and stat_xs.ndim == 1) else P(axis, None)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), spec_tk, spec_t),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    def run(log_pi_, log_A_, ll, xs):
        idx = lax.axis_index(axis)
        dtype = ll.dtype
        A_tilde = jnp.exp(log_A_).astype(dtype)
        lik, shifts = _normalize_loglik(ll)

        # --- per-device tile operator: F0 @ (product of this tile's
        # remaining C-1 transition matrices), chunked tree reduce ---
        S = 1 << (min(block_size, max(C - 1, 1)).bit_length() - 1)
        n_tr = C - 1
        if n_tr > 0:
            pad = _pad_count(n_tr, S)
            nb = (n_tr + pad) // S
            lik_tr = jnp.concatenate(
                [lik[1:], jnp.ones((pad, K), dtype)], axis=0
            ).reshape(nb, S, K)
            val = jnp.concatenate(
                [jnp.ones((n_tr,), bool), jnp.zeros((pad,), bool)], axis=0
            ).reshape(nb, S)
            Qb = _block_products(A_tilde, lik_tr, val, nb, S)
            # chain the block products into ONE tile operator (log-depth)
            Qr = Qb
            while Qr.shape[0] > 1:
                if Qr.shape[0] % 2:
                    Qr = jnp.concatenate(
                        [Qr, jnp.eye(K, dtype=dtype)[None]], axis=0
                    )
                Qr = jnp.einsum("nij,njk->nik", Qr[0::2], Qr[1::2],
                                preferred_element_type=dtype)
                Qr = Qr / jnp.maximum(
                    jnp.max(Qr, axis=(1, 2), keepdims=True),
                    jnp.finfo(dtype).tiny,
                )
            P_rest = Qr[0]
        else:
            P_rest = jnp.eye(K, dtype=dtype)
        F0 = jnp.where(
            idx == 0,
            jnp.eye(K, dtype=dtype) * lik[0][None, :],
            A_tilde * lik[0][None, :],
        )
        Q = F0 @ P_rest
        Q = Q / jnp.maximum(jnp.max(Q), jnp.finfo(dtype).tiny)

        # --- boundary recursions on the gathered tile operators ---
        Qg = lax.all_gather(Q, axis)  # (D, K, K)
        a_last, b_last = _boundary_recursions(
            Qg, jnp.exp(log_pi_).astype(dtype), dtype
        )

        # --- seeded per-tile streaming two-phase sweep ---
        a_in = jnp.take(a_last, jnp.maximum(idx - 1, 0), axis=0)
        log_pi_loc = jnp.where(
            idx == 0,
            log_pi_.astype(dtype),
            jnp.log(jnp.maximum(a_in @ A_tilde, 1e-38)),
        )
        # stat_init seeds ONLY device 0: r.acc is psum-reduced over the
        # time axis below, so a replicated nonzero seed would be counted
        # D times (latent while callers pass zero_stats)
        stat_init_d = (
            jax.tree.map(
                lambda z: jnp.where(idx == 0, z, jnp.zeros_like(z)), stat_init
            )
            if stat_init is not None
            else None
        )
        r = forward_backward_blocked_twophase(
            log_pi_loc,
            log_A_,
            ll,
            block_size=block_size,
            stat_xs=xs if have_stats else None,
            stat_fn=stat_fn,
            stat_init=stat_init_d,
            beta_end=jnp.take(b_last, idx, axis=0),
        )

        # boundary transition INTO this tile (devices d > 0): xi from the
        # replicated a_in, our first likelihood row, and gamma-grade beta
        # at our first step — which is r.init_stats / (a_loc-normalized
        # alpha0), but the clean route is the same identity _chain_tile_fb
        # uses: beta_0 ∝ gamma_0 / alpha_0 with alpha_0 ∝ exp(log_pi_loc)
        # * lik[0]; xi_b normalizes, so scales drop.
        al0 = jnp.exp(log_pi_loc) * lik[0]
        al0 = al0 / jnp.max(al0)  # scale-free: xi_b normalizes below
        beta0 = r.init_stats / jnp.maximum(al0, 1e-30)
        beta0 = beta0 / jnp.max(beta0)
        blb = lik[0] * beta0
        xi_b = A_tilde * jnp.outer(a_in, blb)
        xi_b = xi_b / jnp.maximum(jnp.sum(xi_b), 1e-38)
        gate = jnp.where(idx == 0, 0.0, 1.0).astype(dtype)
        trans = r.trans_stats + gate * xi_b

        init_p = jnp.where(idx == 0, r.init_stats, jnp.zeros((K,), dtype))
        log_z = lax.psum(r.log_z, axis)
        trans = lax.psum(trans, axis)
        init_stats = lax.psum(init_p, axis)
        acc = (
            jax.tree.map(partial(lax.psum, axis_name=axis), r.acc)
            if have_stats
            else jnp.zeros((0,), dtype)
        )
        return log_z, init_stats, trans, acc

    log_z, init_stats, trans, acc = run(log_pi, log_A, log_lik, xs_arg)
    return StreamStats(
        log_z=log_z,
        init_stats=init_stats,
        trans_stats=trans,
        acc=acc if have_stats else None,
    )


def _boundary_recursions(Qg, a0, dtype):
    """Phase-2 boundary messages from the gathered tile operators:
    a_last[d] = normalized filtered alpha at tile d's LAST step, b_last[d]
    = normalized beta there (ones seed at the right edge). Shared by the
    sharded streaming tiers."""
    D, K = Qg.shape[0], Qg.shape[1]
    a = a0
    a_last = []
    for d in range(D):
        a = a @ Qg[d]
        a = a / jnp.sum(a)
        a_last.append(a)
    b = jnp.ones((K,), dtype)
    b_last = [b]
    for d in range(D - 1, 0, -1):
        b = Qg[d] @ b
        b = b / jnp.sum(b)
        b_last.append(b)
    return jnp.stack(a_last), jnp.stack(b_last[::-1])


def time_sharded_fused_stats(
    log_pi: jax.Array,
    log_A: jax.Array,
    obs: jax.Array,  # (T, ...) raw observations — gets time-sharded inside
    ell_fn,  # rows (..., N, obs-dims) -> expected log-lik (..., N, K)
    mesh: Mesh,
    axis: str = "time",
    block_size: int = 1024,
    chunks: int = 8,
    store_alphas: bool | None = None,
    stat_xs: jax.Array | None = None,  # defaults to ``obs``
    stat_fn=None,
    stat_init=None,
    emit_argmax: bool = False,
    time_minor: bool = False,  # obs arrives FEATURE-MAJOR (D, T)
    #   (stream_fused.py); the time axis (now last) is what gets sharded
):
    """Likelihood-FUSED sharded streaming E-step — the multi-device T≈250M+
    route with the single-device fused tier's memory profile per device.

    :func:`time_sharded_long_chain_stats` still materializes each tile's
    (T/D, K) likelihood; here every phase computes likelihoods per chunk
    from the raw observation tile (messages/stream_fused.py), so
    per-device memory is O(T/D · obs-dims) — the route to the reference
    paper's full 250M chromatin chain (SURVEY.md:284). ``emit_argmax
    additionally returns the full argmax-gamma decode, time-sharded
    (StreamStats.z (T,) int32) — the chromatin segmentation deliverable,
    distributed.

    Same three-phase schedule and exactness contract as the non-fused
    sharded tier (seeded per-tile sweeps reproduce the global scaling
    constants; boundary xi needs no extra communication); parity-tested
    against the single-device scan in tests/test_longchain.py.
    """
    from .blocked import StreamStats
    from .stream_fused import (
        _block_products_fused,
        _lik_factory,
        forward_backward_fused_twophase,
    )
    from .blocked import _pad_count

    tm = time_minor and obs.ndim >= 2
    if tm:
        T = obs.shape[-1]
        tail = (obs.shape[0],)
    else:
        T = obs.shape[0]
        tail = obs.shape[1:]
    D = mesh.shape[axis]
    if T % D != 0:
        raise ValueError(f"T={T} must be divisible by time-axis size {D}")
    C = T // D
    probe = jax.eval_shape(
        ell_fn, jax.ShapeDtypeStruct((1,) + tail, obs.dtype)
    )
    K = probe.shape[-1]
    dtype = probe.dtype
    have_stats = stat_fn is not None
    # ship the stats operand only when it genuinely differs from obs:
    # otherwise the inner fused sweep aliases the observation chunks
    # (stat_xs=None) and no second full-tile copy is staged
    xs_is_obs = stat_xs is None or stat_xs is obs
    if tm and not xs_is_obs:
        raise ValueError("time_minor supports stat_xs=None (obs) only")
    ship_xs = have_stats and not xs_is_obs
    xs_arg = stat_xs if ship_xs else jnp.zeros((T, 0), dtype)

    if tm:
        spec_obs = P(*(None,) * (obs.ndim - 1), axis)
    elif obs.ndim == 1:
        spec_obs = P(axis)
    else:
        spec_obs = P(axis, *(None,) * (obs.ndim - 1))
    spec_xs = P(axis) if xs_arg.ndim == 1 else P(axis, *(None,) * (xs_arg.ndim - 1))
    out_specs = (P(), P(), P(), P()) + ((P(axis),) if emit_argmax else ())

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), spec_obs, spec_xs),
        out_specs=out_specs,
        check_vma=False,
    )
    def run(log_pi_, log_A_, o, xs):
        idx = lax.axis_index(axis)
        A_tilde = jnp.exp(log_A_).astype(dtype)
        lik_fn = _lik_factory(ell_fn, dtype)
        rows0 = o[:, :1].T if tm else o[:1]
        lik0, _ = lik_fn(rows0)  # this tile's first likelihood row

        # --- per-device tile operator with in-chunk likelihoods ---
        S = 1 << (min(block_size, max(C - 1, 1)).bit_length() - 1)
        n_tr = C - 1
        if n_tr > 0:
            pad = _pad_count(n_tr, S)
            nb = (n_tr + pad) // S
            if tm:
                o_tr = jnp.concatenate(
                    [o[:, 1:], jnp.zeros(tail + (pad,), o.dtype)], axis=1
                ).reshape(tail + (nb, S))
            else:
                o_tr = jnp.concatenate(
                    [o[1:], jnp.zeros((pad,) + tail, o.dtype)], axis=0
                ).reshape((nb, S) + tail)
            val = jnp.concatenate(
                [jnp.ones((n_tr,), bool), jnp.zeros((pad,), bool)], axis=0
            ).reshape(nb, S)
            Qb = _block_products_fused(
                A_tilde, o_tr, val, nb, S, lik_fn, time_minor=tm
            )
            Qr = Qb
            while Qr.shape[0] > 1:
                if Qr.shape[0] % 2:
                    Qr = jnp.concatenate(
                        [Qr, jnp.eye(K, dtype=dtype)[None]], axis=0
                    )
                Qr = jnp.einsum("nij,njk->nik", Qr[0::2], Qr[1::2],
                                preferred_element_type=dtype)
                Qr = Qr / jnp.maximum(
                    jnp.max(Qr, axis=(1, 2), keepdims=True),
                    jnp.finfo(dtype).tiny,
                )
            P_rest = Qr[0]
        else:
            P_rest = jnp.eye(K, dtype=dtype)
        F0 = jnp.where(
            idx == 0,
            jnp.eye(K, dtype=dtype) * lik0[0][None, :],
            A_tilde * lik0[0][None, :],
        )
        Q = F0 @ P_rest
        Q = Q / jnp.maximum(jnp.max(Q), jnp.finfo(dtype).tiny)

        # --- boundary recursions on the gathered tile operators ---
        Qg = lax.all_gather(Q, axis)  # (D, K, K)
        a_last, b_last = _boundary_recursions(
            Qg, jnp.exp(log_pi_).astype(dtype), dtype
        )

        # --- seeded per-tile FUSED streaming sweep ---
        a_in = jnp.take(a_last, jnp.maximum(idx - 1, 0), axis=0)
        log_pi_loc = jnp.where(
            idx == 0,
            log_pi_.astype(dtype),
            jnp.log(jnp.maximum(a_in @ A_tilde, 1e-38)),
        )
        stat_init_d = (
            jax.tree.map(
                lambda z: jnp.where(idx == 0, z, jnp.zeros_like(z)), stat_init
            )
            if stat_init is not None
            else None
        )
        r = forward_backward_fused_twophase(
            log_pi_loc,
            log_A_,
            o,
            ell_fn,
            block_size=block_size,
            chunks=chunks,
            store_alphas=store_alphas,
            stat_xs=xs if ship_xs else None,
            stat_fn=stat_fn,
            stat_init=stat_init_d,
            beta_end=jnp.take(b_last, idx, axis=0),
            emit_argmax=emit_argmax,
            time_minor=tm,
        )

        # boundary xi INTO this tile (devices d > 0): xi from the
        # replicated a_in, our first likelihood row, and gamma-grade beta
        # at our first step — same identity as the non-fused tier
        al0 = jnp.exp(log_pi_loc) * lik0[0]
        al0 = al0 / jnp.max(al0)
        beta0 = r.init_stats / jnp.maximum(al0, 1e-30)
        beta0 = beta0 / jnp.max(beta0)
        blb = lik0[0] * beta0
        xi_b = A_tilde * jnp.outer(a_in, blb)
        xi_b = xi_b / jnp.maximum(jnp.sum(xi_b), 1e-38)
        gate = jnp.where(idx == 0, 0.0, 1.0).astype(dtype)
        trans = r.trans_stats + gate * xi_b

        init_p = jnp.where(idx == 0, r.init_stats, jnp.zeros((K,), dtype))
        log_z = lax.psum(r.log_z, axis)
        trans = lax.psum(trans, axis)
        init_stats = lax.psum(init_p, axis)
        acc = (
            jax.tree.map(partial(lax.psum, axis_name=axis), r.acc)
            if have_stats
            else jnp.zeros((0,), dtype)
        )
        out = (log_z, init_stats, trans, acc)
        return out + ((r.z,) if emit_argmax else ())

    out = run(log_pi, log_A, obs, xs_arg)
    log_z, init_stats, trans, acc = out[:4]
    return StreamStats(
        log_z=log_z,
        init_stats=init_stats,
        trans_stats=trans,
        acc=acc if have_stats else None,
        z=out[4] if emit_argmax else None,
    )


def time_sharded_forward_backward_batched(
    log_pi: jax.Array,
    log_A: jax.Array,
    log_lik: jax.Array,  # (B, T, K)
    mesh: Mesh,
    batch_axis: str = "data",
    time_axis: str = "time",
    weights: jax.Array | None = None,
) -> FBResult:
    """Exact batched FB on a 2-D (batch, time) mesh: B chains data-parallel,
    each chain's time axis sharded — BASELINE configs 4 and 5 composed.

    Contract mirrors ``messages.e_step_batched``: gamma (B, T, K) and
    log_c (B, T) sharded (batch, time); log_z (B,) and init_stats (B, K)
    sharded over batch; trans_stats (K, K) summed over ALL chains and
    replicated. B must divide the batch axis, T the time axis.
    """
    B, T, K = log_lik.shape
    Db = mesh.shape[batch_axis]
    Dt = mesh.shape[time_axis]
    if B % Db != 0:
        raise ValueError(f"B={B} must be divisible by batch-axis size {Db}")
    if T % Dt != 0:
        raise ValueError(f"T={T} must be divisible by time-axis size {Dt}")

    w_arg = weights if weights is not None else jnp.ones((B, T), log_lik.dtype)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(batch_axis, time_axis, None), P(batch_axis, time_axis)),
        out_specs=(
            P(batch_axis, time_axis, None),
            P(batch_axis),
            P(),
            P(batch_axis, None),
            P(batch_axis, time_axis),
        ),
        check_vma=False,
    )
    def fb(log_pi, log_A, ll, w):  # ll (B_loc, C, K), w (B_loc, C)
        idx = lax.axis_index(time_axis)
        perm = [(i, (i + 1) % Dt) for i in range(Dt)]
        w_prev = lax.ppermute(w[:, -1], time_axis, perm)  # (B_loc,)
        gamma, log_c, trans_p, init_p, log_z_p = jax.vmap(
            lambda ll_b, w_b, wp_b: _chain_tile_fb(
                log_pi, log_A, ll_b, w_b, idx, wp_b, Dt, time_axis
            )
        )(ll, w, w_prev)
        return (
            gamma,
            lax.psum(log_z_p, time_axis),
            lax.psum(jnp.sum(trans_p, axis=0), (batch_axis, time_axis)),
            lax.psum(init_p, time_axis),
            log_c,
        )

    gamma, log_z, trans_stats, init_stats, log_c = fb(log_pi, log_A, log_lik, w_arg)
    return FBResult(
        gamma=gamma,
        log_z=log_z,
        trans_stats=trans_stats,
        init_stats=init_stats,
        log_c=log_c,
    )
