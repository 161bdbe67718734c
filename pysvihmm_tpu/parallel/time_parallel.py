"""Time-parallel inference on ONE long chain: the engine layer over
``messages.time_sharded`` (context parallelism, SURVEY.md §2.4).

The reference has no exact long-chain story beyond a single sequential
Cython loop; its answer to long chains is the SVI subchain estimator. This
module provides the complementary *exact* path: full-chain batch VB where
the time axis of a T = 100k+ chain is sharded over a ``time`` mesh axis,
each coordinate-ascent iteration running forward-backward at sequential
depth T/D with two tiny boundary collectives (see
``messages/time_sharded.py``). Likelihoods and emission sufficient stats
are per-timestep maps/reductions, so GSPMD shards them with the data and
inserts the psum for the stat sums automatically — the only hand-written
communication in the whole step is inside the message kernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..distributions import dirichlet
from ..engines.base import LocalStats, elbo_from_stats
from ..messages.time_sharded import time_sharded_forward_backward
from ..models.hmm import HMMParams, emission_flat_stats, expected_log_params
from ..utils.precision import f32_matmuls


def make_time_mesh(num_devices: int | None = None, devices=None, axis: str = "time") -> Mesh:
    """1-D time mesh over the given (or all) devices."""
    from .data_parallel import make_mesh

    return make_mesh(num_devices, devices=devices, axis=axis)


def shard_chain(
    obs: jax.Array, mesh: Mesh, axis: str = "time", time_minor: bool = False
) -> jax.Array:
    """Place one chain with its TIME axis sharded over the mesh.

    time_minor=True shards the LAST axis of a feature-major (D, T) chain
    (messages/stream_fused.py)."""
    if time_minor and obs.ndim >= 2:
        spec = P(*(None,) * (obs.ndim - 1), axis)
    else:
        spec = P(axis)
    return jax.device_put(obs, NamedSharding(mesh, spec))


@f32_matmuls
def time_sharded_local_step(
    params: HMMParams,
    emission,
    obs: jax.Array,  # (T, D) float or (T,) int, time-sharded
    mesh: Mesh,
    axis: str = "time",
) -> tuple[LocalStats, jax.Array]:
    """Full exact local update on one time-sharded chain.

    Returns (stats, gamma (T, K) time-sharded). Semantically identical to
    ``batch_local_step(params, emission, obs[None])`` on one device
    (tested in tests/test_longchain.py).
    """
    log_pi, log_A = expected_log_params(params)
    ll = emission.expected_log_likelihood(params.emit, obs)  # per-step map
    fb = time_sharded_forward_backward(log_pi, log_A, ll, mesh, axis)
    emit = emission_flat_stats(emission, params.emit, fb.gamma, obs)
    stats = LocalStats(
        init=fb.init_stats, trans=fb.trans_stats, emit=emit, log_z=fb.log_z
    )
    return stats, fb.gamma


@f32_matmuls
def time_sharded_stream_stats(
    params: HMMParams,
    emission,
    obs: jax.Array,  # (T, D) float or (T,) int chain
    mesh: Mesh,
    axis: str = "time",
    block_size: int = 256,
    impl: str = "fused",
    time_minor: bool = False,
) -> LocalStats:
    """STREAMING exact local stats on one time-sharded chain.

    The sharded counterpart of ``engines.base.long_chain_local_stats``:
    gamma is never materialized — each device runs a streaming two-phase
    sweep on its tile seeded by one tiny boundary ``all_gather``
    (messages/time_sharded.py). impl="fused" (default) also computes
    likelihoods per chunk from the raw observation tile
    (messages/stream_fused.py), so per-device memory is O(T/D · obs-dims)
    — the route to the reference paper's T≈250M chromatin chain
    (SURVEY.md:284) on four cards. impl="twophase" materializes each
    tile's (T/D, K) likelihood.
    """
    log_pi, log_A = expected_log_params(params)
    stat_fn = lambda g, y: emission_flat_stats(emission, params.emit, g, y)
    if impl == "fused":
        from ..engines.base import _long_chain_ell_fn
        from ..messages.time_sharded import time_sharded_fused_stats

        r = time_sharded_fused_stats(
            log_pi, log_A, obs, _long_chain_ell_fn(params, emission),
            mesh, axis=axis, block_size=block_size,
            stat_fn=stat_fn,
            stat_init=emission.zero_stats(params.emit),
            time_minor=time_minor,
        )
    else:
        if time_minor:
            raise ValueError("time_minor requires impl='fused'")
        ll = emission.expected_log_likelihood(params.emit, obs)
        from ..messages.time_sharded import time_sharded_long_chain_stats

        r = time_sharded_long_chain_stats(
            log_pi, log_A, ll, mesh, axis=axis, block_size=block_size,
            stat_xs=obs, stat_fn=stat_fn,
            stat_init=emission.zero_stats(params.emit),
        )
    return LocalStats(
        init=r.init_stats, trans=r.trans_stats, emit=r.acc, log_z=r.log_z
    )


@f32_matmuls
def time_sharded_decode(
    params: HMMParams,
    emission,
    obs: jax.Array,
    mesh: Mesh,
    axis: str = "time",
    block_size: int = 1024,
    chunks: int = 8,
    time_minor: bool = False,
) -> jax.Array:
    """Streaming argmax-gamma decode of one time-sharded chain: (T,) int32,
    time-sharded — the distributed counterpart of
    ``engines.base.long_chain_decode`` (the chromatin segmentation
    deliverable at multi-chip scale)."""
    from ..engines.base import _long_chain_ell_fn
    from ..messages.time_sharded import time_sharded_fused_stats

    log_pi, log_A = expected_log_params(params)
    r = time_sharded_fused_stats(
        log_pi, log_A, obs, _long_chain_ell_fn(params, emission),
        mesh, axis=axis, block_size=block_size, chunks=chunks,
        emit_argmax=True, time_minor=time_minor,
    )
    return r.z


def make_ts_stream_vb_step(emission, mesh: Mesh, axis: str = "time",
                           block_size: int = 256, impl: str = "fused",
                           time_minor: bool = False):
    """Jitted coordinate-ascent VB step on one time-sharded chain through
    the STREAMING stats path (no gamma materialization) — exact full-chain
    VB at T beyond one chip's HBM."""

    @jax.jit
    @f32_matmuls
    def step(params: HMMParams, prior: HMMParams, obs: jax.Array):
        stats = time_sharded_stream_stats(
            params, emission, obs, mesh, axis, block_size, impl=impl,
            time_minor=time_minor,
        )
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        new_params = HMMParams(
            init=dirichlet.posterior(prior.init, stats.init),
            trans=dirichlet.posterior(prior.trans, stats.trans),
            emit=emission.posterior(prior.emit, stats.emit),
        )
        return new_params, elbo

    return step


def make_ts_vb_step(emission, mesh: Mesh, axis: str = "time"):
    """Jitted coordinate-ascent VB step on one time-sharded chain."""

    @jax.jit
    @f32_matmuls
    def step(params: HMMParams, prior: HMMParams, obs: jax.Array):
        stats, _ = time_sharded_local_step(params, emission, obs, mesh, axis)
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        new_params = HMMParams(
            init=dirichlet.posterior(prior.init, stats.init),
            trans=dirichlet.posterior(prior.trans, stats.trans),
            emit=emission.posterior(prior.emit, stats.emit),
        )
        return new_params, elbo

    return step


def run_vb_scan(step, params, prior, obs, num_iters: int):
    """Drive a jitted VB step for num_iters iterations as ONE compiled scan.

    Shared by the sharded single-chain engines (time_parallel /
    state_parallel). The carry is the params pytree alone — carrying the
    elbo too would seed the scan with a dtype-fragile dummy scalar.
    """

    @jax.jit
    def run(p, pr, o):
        def body(p, _):
            p2, elbo = step(p, pr, o)
            return p2, elbo

        return jax.lax.scan(body, p, None, length=num_iters)

    return run(params, prior, obs)


def fit_long_chain(
    params: HMMParams,
    prior: HMMParams,
    obs: jax.Array,  # one (T, ...) chain
    emission,
    mesh: Mesh,
    num_iters: int = 100,
    axis: str = "time",
) -> tuple[HMMParams, jax.Array]:
    """Batch VB on one long chain, time-sharded, as one compiled scan.

    The whole optimization loop (num_iters exact full-chain E+M steps)
    compiles to a single XLA program; ELBO history comes back on host.
    """
    obs = shard_chain(obs, mesh, axis)
    step = make_ts_vb_step(emission, mesh, axis)
    return run_vb_scan(step, params, prior, obs, num_iters)
