"""Batch mean-field VB by coordinate ascent (reference ``hmmbatchcd.py``).

Reconstructed behavior (SURVEY.md §3 call stack A): per iteration, a full
local update on all sequences followed by the exact conjugate global update;
the reported ELBO sequence is strictly non-decreasing (a real invariant of
coordinate-ascent VB, property-tested in tests/test_batch_vb.py).

Design: one jitted step = batched E-step over the sequence batch + fused
conjugate updates. `fit` drives it with `lax.scan` so the
whole inference loop compiles to a single XLA program; the batch axis may be
sharded over a device mesh (see pysvihmm_tpu.parallel) in which case the
stat sums below become psums automatically under jit.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..distributions import dirichlet
from ..models.hmm import HMMParams, init_params
from ..utils.precision import f32_matmuls
from .base import batch_local_step, elbo_from_stats, long_chain_local_stats


class BatchVBState(NamedTuple):
    params: HMMParams
    elbo: jax.Array  # ELBO at the params that *produced* the last local step


def make_step(emission, method: str = "auto"):
    """Build the jitted coordinate-ascent step: (params, prior, obs) -> (params', elbo)."""

    @partial(jax.jit, static_argnames=())
    @f32_matmuls
    def step(params: HMMParams, prior: HMMParams, obs: jax.Array):
        stats, _ = batch_local_step(params, emission, obs, method, need_gamma=False)
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        new_params = HMMParams(
            init=dirichlet.posterior(prior.init, stats.init),
            trans=dirichlet.posterior(prior.trans, stats.trans),
            emit=emission.posterior(prior.emit, stats.emit),
        )
        return new_params, elbo

    return step


def fit(
    params: HMMParams,
    prior: HMMParams,
    obs: jax.Array,
    emission,
    num_iters: int = 100,
    method: str = "auto",
) -> tuple[HMMParams, jax.Array]:
    """Run `num_iters` coordinate-ascent iterations as one compiled scan.

    Returns (final params, elbo history (num_iters,)). Convergence-tolerance
    stopping is done host-side by the caller if needed (the reference stops
    on relative ELBO change; we return the full history instead so the loop
    stays device-resident).
    """

    @f32_matmuls
    def body(p, _):
        stats, _ = batch_local_step(p, emission, obs, method, need_gamma=False)
        elbo = elbo_from_stats(p, prior, emission, stats.log_z)
        new_p = HMMParams(
            init=dirichlet.posterior(prior.init, stats.init),
            trans=dirichlet.posterior(prior.trans, stats.trans),
            emit=emission.posterior(prior.emit, stats.emit),
        )
        return new_p, elbo

    final, elbos = jax.lax.scan(body, params, None, length=num_iters)
    return final, elbos


def fit_restarts(
    key: jax.Array,
    prior: HMMParams,
    obs: jax.Array,
    emission,
    num_iters: int = 100,
    num_restarts: int = 8,
    method: str = "auto",
) -> tuple[HMMParams, jax.Array, jax.Array]:
    """Best-of-N-seeds batch VB: all restarts run in parallel under one vmap.

    Coordinate-ascent VB is deterministic given its init, and single-seed
    runs can land in merged-state local optima on hard data. The reference's
    workflow re-runs the engine by hand; here the idiomatic answer is to
    vmap the *entire* fit over a batch of farthest-point/noise inits — one
    compile, the restart axis batched alongside the sequence batch — and
    select the winner by final ELBO on device.

    Returns (best params, elbo histories (num_restarts, num_iters),
    best restart index). `elbos[best, -1]` is the winning ELBO.
    """
    keys = jax.random.split(key, num_restarts)
    inits = jax.vmap(lambda k: init_params(k, prior, emission, obs))(keys)
    finals, elbos = jax.vmap(
        lambda p0: fit(p0, prior, obs, emission, num_iters, method)
    )(inits)
    best = jnp.argmax(elbos[:, -1])
    best_params = jax.tree.map(lambda x: x[best], finals)
    return best_params, elbos, best


def make_long_chain_step(emission, block_size: int = 256,
                         impl: str | None = None, time_minor: bool = False):
    """Jitted coordinate-ascent VB step on ONE very long chain.

    The single-device counterpart of ``parallel.time_parallel.make_ts_vb_step``
    for the reference paper's T = millions single-chain regime: the E-step
    streams through ``engines.base.long_chain_local_stats`` (default: the
    likelihood-fused tier; ``time_minor=True`` takes the chain
    feature-major (D, T)).
    (params, prior, chain (T, D) | (T,) | (D, T)) -> (new_params, elbo).
    """

    @jax.jit
    @f32_matmuls
    def step(params: HMMParams, prior: HMMParams, chain: jax.Array):
        stats = long_chain_local_stats(
            params, emission, chain, block_size, impl=impl,
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
