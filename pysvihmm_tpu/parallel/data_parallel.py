"""Data-parallel inference over a device mesh: the replacement for the
reference's ``multiprocessing.Pool`` local-step fan-out.

Reference call stack D (SURVEY.md §3): ``Pool.map(local_step, minibatch)``
followed by a host-side stat reduce. Here the same shape is
``shard_map(vmap(local_step))`` over a 1-D ``data`` mesh axis with `psum`
reducing the expected sufficient statistics over the interconnect (NVLink
between the cards of one host) — bit-equivalent to the single-device path
(tested in tests/test_sharding.py) and scaling to multi-host meshes with
the same `psum` (SURVEY.md §2.4/§5).

Global parameters stay replicated (they are KB-scale); only sequences and
their messages are sharded. This is the right layout for this model family:
all collective traffic is the K*K + K*stats pytree once per step.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..distributions import dirichlet
from ..engines.base import (
    LocalStats,
    batch_local_step,
    elbo_from_stats,
    windowed_local_step,
)
from ..engines.svi import SVIState
from ..models.hmm import HMMParams, global_kl
from ..utils.schedules import power_schedule
from .. import messages
from ..utils.precision import f32_matmuls


def default_devices():
    """Devices on the platform computations will actually run on.

    Honors an explicitly configured ``jax_default_device`` (the test harness
    pins the CPU — on a machine with a GPU a bare ``jax.devices()`` would
    build GPU meshes there); otherwise all devices of the default backend.
    """
    dd = jax.config.jax_default_device
    platform = getattr(dd, "platform", None)
    return jax.devices(platform) if platform else jax.devices()


def make_mesh(num_devices: int | None = None, devices=None, axis: str = "data") -> Mesh:
    """1-D data mesh over the given (or all default-platform) devices."""
    if devices is None:
        devices = default_devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (axis,))


def shard_batch(obs: jax.Array, mesh: Mesh) -> jax.Array:
    """Place a (B, ...) batch with the leading axis sharded over the mesh."""
    return jax.device_put(obs, NamedSharding(mesh, P("data")))


def replicate(tree, mesh: Mesh):
    return jax.device_put(tree, NamedSharding(mesh, P()))


def sharded_local_step(params, emission, obs, mesh, method: str = "auto",
                       interpret: bool = False):
    """shard_map'd batch local step: per-shard batched FB, psum'd stats.

    obs: (B, T, ...) with B divisible by mesh size. Returns LocalStats
    identical (up to float reduction order) to the single-device result.
    ``interpret`` runs the kernel method in the Pallas interpreter (tests).
    """

    def local(p, o):
        stats, _ = batch_local_step(
            p, emission, o, method, need_gamma=False, interpret=interpret
        )
        return jax.tree.map(partial(jax.lax.psum, axis_name="data"), stats)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P("data")),
        out_specs=P(),
        # pallas_call outputs don't carry mesh-axis variance (vma)
        # metadata; the stats are psum-reduced to replicated regardless
        check_vma=False,
    )(params, obs)


def make_dp_vb_step(emission, mesh: Mesh, method: str = "auto"):
    """Data-parallel coordinate-ascent VB step (engines/batch_vb over a mesh)."""

    @jax.jit
    @f32_matmuls
    def step(params: HMMParams, prior: HMMParams, obs: jax.Array):
        stats = sharded_local_step(params, emission, obs, mesh, method)
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        new_params = HMMParams(
            init=dirichlet.posterior(prior.init, stats.init),
            trans=dirichlet.posterior(prior.trans, stats.trans),
            emit=emission.posterior(prior.emit, stats.emit),
        )
        return new_params, elbo

    return step


def make_dp_minibatch_svi_step(emission, cfg, num_seqs: int, mesh: Mesh,
                               method: str = "auto"):
    """Data-parallel minibatch-of-sequences SVI (engines/svi.make_minibatch_step
    over a mesh): each device samples B/n sequences from its local shard view,
    local steps run shard-parallel, stats psum over the mesh.

    obs must be passed sharded over its leading axis (see :func:`shard_batch`).
    The global natural-gradient step happens replicated on every device —
    identical arithmetic, zero extra communication (SURVEY.md §2.4).
    """
    B = cfg.batch_size
    n_dev = mesh.devices.size
    if B % n_dev != 0:
        raise ValueError(f"batch_size {B} not divisible by mesh size {n_dev}")
    B_local = B // n_dev
    scale = num_seqs / B

    def local(params, prior, obs_shard, key):
        # per-device distinct key
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        n_local = obs_shard.shape[0]
        idx = jax.random.randint(key, (B_local,), 0, n_local)
        batch = obs_shard[idx]

        # unified batched local step: resolves method="auto" (the kernel on
        # a CUDA device) and already sums stats over the shard
        stats, _ = batch_local_step(params, emission, batch, method, need_gamma=False)
        return jax.tree.map(partial(jax.lax.psum, axis_name="data"), stats)

    @jax.jit
    @f32_matmuls
    def step(state: SVIState, prior: HMMParams, obs: jax.Array):
        params = state.params
        key, k_step = jax.random.split(state.key)
        stats = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(), P("data"), P()),
            out_specs=P(),
            check_vma=False,  # pallas outputs carry no vma metadata
        )(params, prior, obs, k_step)

        # rho: power schedule, or the elastic adaptive rule (replicated
        # arithmetic on the psum'd stats -> identical on every device)
        from ..engines.svi import _resolve_rho

        target = HMMParams(
            init=dirichlet.posterior(prior.init, scale * stats.init),
            trans=dirichlet.posterior(prior.trans, scale * stats.trans),
            emit=emission.nat_grad_step(params.emit, prior.emit, stats.emit, scale, 1.0),
        )
        rho, new_adapt = _resolve_rho(state, cfg, target)
        new_params = HMMParams(
            init=dirichlet.nat_grad_step(params.init, prior.init, stats.init, scale, rho),
            trans=dirichlet.nat_grad_step(
                params.trans, prior.trans, stats.trans, scale, rho
            ),
            emit=emission.nat_grad_step(params.emit, prior.emit, stats.emit, scale, rho),
        )
        noisy_elbo = scale * stats.log_z - global_kl(params, prior, emission)
        return (
            SVIState(params=new_params, step=state.step + 1, key=key, adapt=new_adapt),
            {"rho": rho, "noisy_elbo": noisy_elbo},
        )

    return step


def make_dp_streamed_svi_step(emission, cfg, num_seqs: int, mesh: Mesh,
                              method: str = "auto"):
    """Minibatch-of-sequences SVI whose batches arrive from a HOST pipeline.

    The corpus-in-HBM variant (:func:`make_dp_minibatch_svi_step`) samples
    indices on-device from a resident (N, T, ...) array; at the 100k-1M
    sequence scale (BASELINE config 5) the corpus lives on disk instead and
    a :class:`~pysvihmm_tpu.data.loader.ShardedSequenceLoader` streams
    shuffled, globally-sharded (B, T, ...) batches. This step consumes one
    such batch per call: shard-parallel local steps, psum'd stats, and the
    replicated natural-gradient update with the N/B unbiasedness scale.
    """
    scale = num_seqs / cfg.batch_size

    @jax.jit
    @f32_matmuls
    def step(state: SVIState, prior: HMMParams, batch: jax.Array):
        params = state.params
        stats = sharded_local_step(params, emission, batch, mesh, method)

        from ..engines.svi import _resolve_rho

        target = HMMParams(
            init=dirichlet.posterior(prior.init, scale * stats.init),
            trans=dirichlet.posterior(prior.trans, scale * stats.trans),
            emit=emission.nat_grad_step(params.emit, prior.emit, stats.emit, scale, 1.0),
        )
        rho, new_adapt = _resolve_rho(state, cfg, target)
        new_params = HMMParams(
            init=dirichlet.nat_grad_step(params.init, prior.init, stats.init, scale, rho),
            trans=dirichlet.nat_grad_step(
                params.trans, prior.trans, stats.trans, scale, rho
            ),
            emit=emission.nat_grad_step(params.emit, prior.emit, stats.emit, scale, rho),
        )
        noisy_elbo = scale * stats.log_z - global_kl(params, prior, emission)
        return (
            SVIState(params=new_params, step=state.step + 1, key=state.key,
                     adapt=new_adapt),
            {"rho": rho, "noisy_elbo": noisy_elbo},
        )

    return step


def make_dp_metaobs_step(emission, cfg, chain_len: int, mesh: Mesh,
                         method: str = "auto"):
    """Data-parallel meta-observation SVI: the direct translation of the
    reference's Pool-parallel ``hmmsgd_metaobs`` engine. The chain is
    replicated (windows are gathered per device); the minibatch of blocks is
    split across the mesh, exactly like Pool tasks across workers.
    """
    from ..engines.svi import _gather_windows

    M, Lm, b = cfg.minibatch, cfg.block_len, cfg.buffer
    T = chain_len
    if T % Lm != 0:
        raise ValueError(f"chain length {T} must be a multiple of block_len {Lm}")
    num_blocks = T // Lm
    n_dev = mesh.devices.size
    if M % n_dev != 0:
        raise ValueError(f"minibatch {M} not divisible by mesh size {n_dev}")
    M_local = M // n_dev
    method, W, b_left = messages.plan_window(method, Lm, b)

    scale_trans = (T - 1.0) / (M * max(Lm - 1, 1))
    scale_emit = num_blocks / M
    scale_init = num_blocks / M

    def local(params, obs, block_ids_shard):
        starts = block_ids_shard * Lm
        ws = jnp.clip(starts - b_left, 0, T - W)
        offs = starts - ws
        windows = _gather_windows(obs, ws, W)
        pos = jnp.arange(W)[None, :]
        maskf = ((pos >= offs[:, None]) & (pos < offs[:, None] + Lm)).astype(
            params.init.dtype
        )
        # shared windowed local step (engines/base.py): the kernel on a
        # CUDA device, scan elsewhere; trans_stats come back pair-gated by
        # the mask and summed over the shard
        emit_stats, trans_stats, gamma_at_start, log_c = windowed_local_step(
            params, emission, windows, maskf, offs, method
        )
        is_first = (block_ids_shard == 0).astype(params.init.dtype)[:, None]
        stats = LocalStats(
            init=jnp.sum(gamma_at_start * is_first, 0),
            trans=trans_stats,
            emit=emit_stats,
            log_z=jnp.sum(log_c * maskf),
        )
        return jax.tree.map(partial(jax.lax.psum, axis_name="data"), stats)

    @jax.jit
    @f32_matmuls
    def step(state: SVIState, prior: HMMParams, obs: jax.Array):
        params = state.params
        key, k_blocks = jax.random.split(state.key)
        block_ids = jax.random.choice(k_blocks, num_blocks, (M,), replace=False)
        stats = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(), P("data")),
            out_specs=P(),
            check_vma=False,  # pallas outputs carry no vma metadata
        )(params, obs, block_ids)

        rho = power_schedule(state.step.astype(params.init.dtype), cfg.tau, cfg.kappa)
        new_params = HMMParams(
            init=dirichlet.nat_grad_step(
                params.init, prior.init, stats.init, scale_init, rho
            ),
            trans=dirichlet.nat_grad_step(
                params.trans, prior.trans, stats.trans, scale_trans, rho
            ),
            emit=emission.nat_grad_step(
                params.emit, prior.emit, stats.emit, scale_emit, rho
            ),
        )
        noisy_elbo = scale_emit * stats.log_z - global_kl(params, prior, emission)
        return (
            SVIState(params=new_params, step=state.step + 1, key=key),
            {"rho": rho, "noisy_elbo": noisy_elbo},
        )

    return step
