"""Stochastic variational inference over minibatched, buffered subchains.

Reference: ``pysvihmm/hmmsvi.py`` (reconstructed — SURVEY.md §2.2/§3C),
implementing Foti, Xu, Laird, Fox (NIPS 2014) Algorithm 1: sample B
length-L subchains from one long chain, extend each by a buffer of b steps
per side, run forward-backward on the L+2b window, keep only the middle-L
expected sufficient statistics, scale them to be unbiased for the full
chain, and take a natural-gradient step with rho_t = (t + tau)^(-kappa).
Also covers the reference's ``hmmbatchsgd.py`` (full-data natural-gradient
VB) as the degenerate schedule on full batches — see engines/batch_sgd.py.

Design notes:
  * Subchain windows have *static* shape (B, L+2b): starts are sampled on
    device, windows gathered with `dynamic_slice`, and chain-edge clipping
    is expressed through a per-window 0/1 kept-mask — no dynamic shapes
    under jit.
  * The whole update (sample -> gather -> vmapped FB -> masked stats ->
    natural-gradient blend) is ONE jitted function with the PRNG key and
    step count carried in device-side state, so `fit` can run thousands of
    steps inside a single `lax.scan` without host round-trips.
  * Scaling factors (the estimator's unbiasedness constants): transitions
    (T-1)/(B(L-1)), emissions T/(BL), initial state (T-L+1)/B gated on a
    window actually starting at t=0. Convention note (audited): each
    window contributes EXACTLY L-1 units of pairwise mass (every xi_t
    sums to 1), so (T-1)/(B(L-1)) makes the TOTAL transition pseudo-count
    mass exactly unbiased (E = T-1); per-position it runs (T-1)/(T-L+1)
    hot in the interior and cool at the chain edges (positions covered by
    fewer uniform starts) — an O(L/T) distortion matching the paper's
    convention and the reference's sampler [MED]. The alternative
    (T-L+1)/(B(L-1)) would be interior-position-unbiased but undercount
    total mass; do not "fix" one into the other without moving the
    tests/test_svi.py unbiasedness assertions deliberately.

Multi-sequence datasets (minibatches over sequences — BASELINE config 5)
are handled by :func:`make_minibatch_step`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..distributions import dirichlet
from ..models.hmm import HMMParams, expected_log_params
from ..utils.schedules import power_schedule
from .. import messages
from .base import batch_local_step, windowed_local_step
from ..utils.precision import f32_matmuls


class SVIConfig(NamedTuple):
    """Hyperparameters of the subchain-SVI estimator (reference ctor kwargs)."""

    batch_size: int = 32  # B subchains per step
    subchain_len: int = 50  # L kept positions per subchain
    buffer: int = 10  # b buffer steps on each side (paper §3.2)
    tau: float = 1.0  # step-size delay
    kappa: float = 0.6  # forgetting rate, in (0.5, 1]
    adaptive: bool = False  # elastic step-size adaptation (Ranganath et al.)


class SVIState(NamedTuple):
    params: HMMParams
    step: jax.Array  # () int32
    key: jax.Array  # PRNG key, device-side
    adapt: object = None  # AdaptiveState when cfg.adaptive, else None


def init_state(
    params: HMMParams, key: jax.Array, adaptive: bool = False
) -> SVIState:
    adapt = None
    if adaptive:
        from ..utils.schedules import adaptive_init

        dim = sum(x.size for x in jax.tree.leaves(params))
        adapt = adaptive_init(dim, params.init.dtype)
    return SVIState(params=params, step=jnp.asarray(0, jnp.int32), key=key, adapt=adapt)


def _nat_flat(params: HMMParams) -> jax.Array:
    """Flatten global params in NATURAL coordinates (where the conjugate SVI
    update is linear) for the adaptive-step moment estimates."""
    from ..distributions import diag_gaussian, niw

    leaves = [params.init, params.trans]
    if isinstance(params.emit, niw.NIW):
        leaves += list(niw.to_natural(params.emit))
    elif isinstance(params.emit, diag_gaussian.NIG):
        leaves += list(diag_gaussian.to_natural(params.emit))
    else:
        leaves.append(params.emit)
    return jnp.concatenate([jnp.ravel(x) for x in leaves])


def _resolve_rho(state: SVIState, cfg, target: HMMParams):
    """rho_t from the power schedule, or the elastic adaptive rule driven by
    the natural-gradient (target - params) moments (SURVEY.md §5 'elastic
    step-size adaptation'). Returns (rho, new_adapt_state)."""
    dtype = state.params.init.dtype
    if not cfg.adaptive:
        return power_schedule(state.step.astype(dtype), cfg.tau, cfg.kappa), state.adapt
    from ..utils.schedules import adaptive_update

    grad = _nat_flat(target) - _nat_flat(state.params)
    new_adapt, rho = adaptive_update(state.adapt, grad)
    return rho, new_adapt


def _gather_windows(obs: jax.Array, window_starts: jax.Array, W: int) -> jax.Array:
    """Static-shape gather of B windows obs[s : s+W] as ONE batched gather.

    A vmapped `dynamic_slice` can lower to a SEQUENTIAL device loop over
    the B batched start indices; a `take` over precomputed (B, W) row
    indices is ONE parallel gather. Starts are pre-clipped to [0, T-W] by
    the callers; clip mode keeps even a bad caller in-bounds rather than
    UB.
    """
    idx = window_starts[:, None] + jnp.arange(W, dtype=window_starts.dtype)
    return jnp.take(obs, idx, axis=0, mode="clip")


def make_step(emission, cfg: SVIConfig, chain_len: int, method: str = "auto"):
    """Build the jitted SVI step for a single chain of static length T.

    Returns step(state, prior, obs) -> (state', metrics dict).
    """
    B, L, b = cfg.batch_size, cfg.subchain_len, cfg.buffer
    T = chain_len
    method, W, b_left = messages.plan_window(method, L, b)
    if W > T:
        raise ValueError(f"window {W} longer than chain {T}")
    num_starts = T - L + 1

    scale_trans = (T - 1.0) / (B * max(L - 1, 1))
    scale_emit = T / (B * L)
    scale_init = num_starts / B

    def step(state: SVIState, prior: HMMParams, obs: jax.Array):
        key, k_starts = jax.random.split(state.key)
        params = state.params

        starts = jax.random.randint(k_starts, (B,), 0, num_starts)
        ws = jnp.clip(starts - b_left, 0, T - W)  # clipped window starts
        offs = starts - ws  # kept-region offset inside each window
        windows = _gather_windows(obs, ws, W)  # (B, W, ...)

        pos = jnp.arange(W)[None, :]
        mask = (pos >= offs[:, None]) & (pos < offs[:, None] + L)  # (B, W)
        maskf = mask.astype(params.init.dtype)

        # Shared windowed local step (engines/base.py): masked emission
        # stats, pair-gated batch-summed trans stats, per-window gamma at
        # the kept-region offset, per-step log normalizers.
        emit_stats, trans_stats, gamma_at_start, log_c = windowed_local_step(
            params, emission, windows, maskf, offs, method
        )

        # Initial-state stats: gamma at the chain start, only for windows
        # whose subchain begins at t=0; unbiased via inverse inclusion prob.
        is_chain_start = (starts == 0).astype(params.init.dtype)[:, None]
        init_stats = jnp.sum(gamma_at_start * is_chain_start, axis=0)

        target = HMMParams(
            init=dirichlet.posterior(prior.init, scale_init * init_stats),
            trans=dirichlet.posterior(prior.trans, scale_trans * trans_stats),
            emit=emission.nat_grad_step(
                params.emit, prior.emit, emit_stats, scale_emit, 1.0
            ),
        )
        rho, new_adapt = _resolve_rho(state, cfg, target)

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

        # Noisy lower-bound estimate: scaled kept-region log-normalizer mass
        # minus the global KL (the reference's "stochastic lower bound").
        from ..models.hmm import global_kl

        local_mass = jnp.sum(log_c * maskf)
        noisy_elbo = scale_emit * local_mass - global_kl(params, prior, emission)

        metrics = {"rho": rho, "noisy_elbo": noisy_elbo}
        return (
            SVIState(params=new_params, step=state.step + 1, key=key, adapt=new_adapt),
            metrics,
        )

    return jax.jit(f32_matmuls(step))


def fit(
    state: SVIState,
    prior: HMMParams,
    obs: jax.Array,
    emission,
    cfg: SVIConfig,
    num_steps: int,
    method: str = "auto",
) -> tuple[SVIState, dict]:
    """Run num_steps SVI updates as one compiled scan over device-side state."""
    step = make_step(emission, cfg, obs.shape[0], method)

    def body(s, _):
        s2, m = step(s, prior, obs)
        return s2, m

    final, metrics = jax.lax.scan(body, state, None, length=num_steps)
    return final, metrics


def fit_minibatch(
    state: SVIState,
    prior: HMMParams,
    obs: jax.Array,
    emission,
    cfg: SVIConfig,
    num_steps: int,
    method: str = "auto",
) -> tuple[SVIState, dict]:
    """Run num_steps minibatch-of-sequences SVI updates as one compiled scan."""
    step = make_minibatch_step(emission, cfg, obs.shape[0], method)

    def body(s, _):
        s2, m = step(s, prior, obs)
        return s2, m

    final, metrics = jax.lax.scan(body, state, None, length=num_steps)
    return final, metrics


def fit_restarts(
    key: jax.Array,
    prior: HMMParams,
    obs: jax.Array,
    emission,
    cfg: SVIConfig,
    num_steps: int,
    num_restarts: int = 8,
    method: str = "auto",
) -> tuple[SVIState, jax.Array, jax.Array]:
    """Best-of-N-seeds single-chain SVI, all restarts vmapped in one compile.

    Stochastic trajectories differ both by init and by minibatch sampling
    path, and like batch VB they can land in merged-state optima. Each
    restart gets independent init AND sampling keys; the winner is selected
    by the EXACT full-chain lower bound at the final parameters (one extra
    full local step per restart — the per-step noisy ELBO is too noisy to
    rank restarts). Returns (best final state, exact final ELBOs
    (num_restarts,), best index).
    """
    from ..models.hmm import init_params
    from .base import lower_bound

    def one(k):
        k_init, k_samp = jax.random.split(k)
        p0 = init_params(k_init, prior, emission, obs)
        st0 = init_state(p0, k_samp, adaptive=cfg.adaptive)
        st, _ = fit(st0, prior, obs, emission, cfg, num_steps, method)
        elbo = lower_bound(st.params, prior, emission, obs[None], method)
        return st, elbo

    states, elbos = jax.vmap(one)(jax.random.split(key, num_restarts))
    best = jnp.argmax(elbos)
    best_state = jax.tree.map(lambda x: x[best], states)
    return best_state, elbos, best


def select_buffer(
    params: HMMParams,
    chain: jax.Array,
    emission,
    subchain_len: int,
    key: jax.Array,
    tol: float = 1e-3,
    b_init: int = 1,
    b_max: int | None = None,
    probes: int = 8,
) -> int:
    """Adaptive buffer-length selection (Foti et al. 2014 §3.2).

    The paper proves the error of buffered subchain marginals decays
    geometrically in the buffer length b and proposes choosing b adaptively.
    This implements the doubling test: starting from ``b_init``, compare the
    kept-region marginals computed with buffer b against buffer 2b on
    ``probes`` random subchains; if they agree to ``tol`` (max-abs over
    gamma), b is sufficient — else double and repeat. Host-level utility
    (one jit per candidate b); run once against the current variational
    params before (or periodically during) training.
    """
    T = chain.shape[0]
    L = subchain_len
    if b_max is None:
        b_max = max(1, min(L, (T - L) // 4, 64))
    log_pi, log_A = expected_log_params(params)

    b = max(1, b_init)
    while True:
        b2 = 2 * b
        W2 = L + 2 * b2
        if b2 > b_max or W2 > T:
            return min(b, b_max)
        key, k = jax.random.split(key)
        starts = jax.random.randint(k, (probes,), 0, T - W2 + 1)
        wins = _gather_windows(chain, starts, W2)  # (probes, W2, ...)
        ll2 = emission.expected_log_likelihood(params.emit, wins)
        fb2 = jax.vmap(lambda l: messages.e_step(log_pi, log_A, l))(ll2)
        ll1 = ll2[:, b2 - b : b2 - b + L + 2 * b]
        fb1 = jax.vmap(lambda l: messages.e_step(log_pi, log_A, l))(ll1)
        g2 = fb2.gamma[:, b2 : b2 + L]
        g1 = fb1.gamma[:, b : b + L]
        err = float(jnp.max(jnp.abs(g1 - g2)))
        if err < tol:
            return b
        b = b2


def make_minibatch_step(emission, cfg: SVIConfig, num_seqs: int, method: str = "auto"):
    """SVI over minibatches of whole sequences from a (N, T, ...) dataset.

    The many-independent-sequences regime (BASELINE config 5): B sequences
    sampled per step, stats scaled by N/B. Subsumes the reference's use of
    SVI on sequence collections; with B=N it reduces to batch natural-
    gradient VB (tested against engines/batch_sgd.py).
    """
    B = cfg.batch_size
    N = num_seqs
    scale = N / B

    def step(state: SVIState, prior: HMMParams, obs: jax.Array):
        key, k_idx = jax.random.split(state.key)
        params = state.params
        idx = jax.random.randint(k_idx, (B,), 0, N)
        batch = obs[idx]

        # unified batched local step (engines/base.py): the kernel on a
        # CUDA device, scan elsewhere; stats arrive summed
        stats, _ = batch_local_step(params, emission, batch, method, need_gamma=False)
        emit_stats, init_stats, trans_stats = stats.emit, stats.init, stats.trans

        target = HMMParams(
            init=dirichlet.posterior(prior.init, scale * init_stats),
            trans=dirichlet.posterior(prior.trans, scale * trans_stats),
            emit=emission.nat_grad_step(params.emit, prior.emit, emit_stats, scale, 1.0),
        )
        rho, new_adapt = _resolve_rho(state, cfg, target)

        new_params = HMMParams(
            init=dirichlet.nat_grad_step(params.init, prior.init, init_stats, scale, rho),
            trans=dirichlet.nat_grad_step(
                params.trans, prior.trans, trans_stats, scale, rho
            ),
            emit=emission.nat_grad_step(params.emit, prior.emit, emit_stats, scale, rho),
        )
        from ..models.hmm import global_kl

        noisy_elbo = scale * stats.log_z - global_kl(params, prior, emission)
        metrics = {"rho": rho, "noisy_elbo": noisy_elbo}
        return (
            SVIState(params=new_params, step=state.step + 1, key=key, adapt=new_adapt),
            metrics,
        )

    return jax.jit(f32_matmuls(step))
