"""SVI over meta-observations with parallel local steps.

Reference: ``pysvihmm/hmmsgd_metaobs.py`` (reconstructed — SURVEY.md §2.2,
§3D), the reference's largest engine: the chain is partitioned into
contiguous "meta-observation" blocks; each iteration samples a minibatch of
blocks, fans the buffered local steps out over a ``multiprocessing.Pool``,
reduces the workers' stats, and takes a natural-gradient step.

Translation of the Pool.map -> reduce shape (SURVEY.md §3D note): the
minibatch of blocks becomes a leading batch axis on one device and is
sharded over the `data` mesh axis across devices
(`shard_map(vmap(local_step))` + `psum` — see pysvihmm_tpu/parallel/), with
bit-identical semantics to the single-device path.

Estimator details: blocks are length-Lm and aligned; sampling is without
replacement within a minibatch (matching Pool semantics of distinct tasks);
buffers of b steps are taken from neighboring blocks (clipped at chain
edges via the kept-mask machinery shared with engines/svi.py). Transitions
*between* blocks are not covered by any minibatch — the same O(1/Lm)
truncation the reference's metaobs estimator has; buffering bounds the
resulting bias (paper §3.2).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..distributions import dirichlet
from ..models.hmm import HMMParams, global_kl
from ..utils.schedules import power_schedule
from .. import messages
from .base import windowed_local_step
from .svi import SVIState, _gather_windows, init_state  # shared state pytree
from ..utils.precision import f32_matmuls


class MetaObsConfig(NamedTuple):
    minibatch: int = 8  # M blocks per step
    block_len: int = 100  # Lm observations per meta-observation
    buffer: int = 10  # b buffered steps on each side
    tau: float = 1.0
    kappa: float = 0.6


def make_step(emission, cfg: MetaObsConfig, chain_len: int, method: str = "auto"):
    M, Lm, b = cfg.minibatch, cfg.block_len, cfg.buffer
    T = chain_len
    if T % Lm != 0:
        raise ValueError(f"chain length {T} must be a multiple of block_len {Lm}")
    num_blocks = T // Lm
    if M > num_blocks:
        raise ValueError("minibatch larger than number of meta-observations")
    method, W, b_left = messages.plan_window(method, Lm, b)

    scale_trans = (T - 1.0) / (M * max(Lm - 1, 1))
    scale_emit = num_blocks / M
    scale_init = num_blocks / M

    def step(state: SVIState, prior: HMMParams, obs: jax.Array):
        key, k_blocks = jax.random.split(state.key)
        params = state.params

        # Sample M distinct block ids (without replacement, Pool-task style).
        block_ids = jax.random.choice(k_blocks, num_blocks, (M,), replace=False)
        starts = block_ids * Lm
        ws = jnp.clip(starts - b_left, 0, T - W)
        offs = starts - ws
        windows = _gather_windows(obs, ws, W)

        pos = jnp.arange(W)[None, :]
        mask = (pos >= offs[:, None]) & (pos < offs[:, None] + Lm)
        maskf = mask.astype(params.init.dtype)

        # The Pool.map analog: shared batched windowed local step
        # (engines/base.py; shard over mesh upstream).
        emit_stats, trans_stats, gamma_at_start, log_c = windowed_local_step(
            params, emission, windows, maskf, offs, method
        )
        is_first_block = (block_ids == 0).astype(params.init.dtype)[:, None]
        init_stats = jnp.sum(gamma_at_start * is_first_block, axis=0)

        rho = power_schedule(state.step.astype(params.init.dtype), cfg.tau, cfg.kappa)
        new_params = HMMParams(
            init=dirichlet.nat_grad_step(
                params.init, prior.init, init_stats, scale_init, rho
            ),
            trans=dirichlet.nat_grad_step(
                params.trans, prior.trans, trans_stats, scale_trans, rho
            ),
            emit=emission.nat_grad_step(
                params.emit, prior.emit, emit_stats, scale_emit, rho
            ),
        )

        local_mass = jnp.sum(log_c * maskf)
        noisy_elbo = scale_emit * local_mass - global_kl(params, prior, emission)
        metrics = {"rho": rho, "noisy_elbo": noisy_elbo}
        return SVIState(params=new_params, step=state.step + 1, key=key), metrics

    return jax.jit(f32_matmuls(step))


def fit(
    state: SVIState,
    prior: HMMParams,
    obs: jax.Array,
    emission,
    cfg: MetaObsConfig,
    num_steps: int,
    method: str = "auto",
) -> tuple[SVIState, dict]:
    step = make_step(emission, cfg, obs.shape[0], method)

    def body(s, _):
        s2, m = step(s, prior, obs)
        return s2, m

    final, metrics = jax.lax.scan(body, state, None, length=num_steps)
    return final, metrics
