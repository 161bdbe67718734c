"""Reference-shaped class API (compat layer).

The reference exposes engine classes constructed with
``(obs, prior_init, prior_tran, prior_emit, ...)`` carrying mutable
``var_init / var_tran / var_emit`` attributes and an ``.infer()`` loop
(``pysvihmm/hmmbase.py`` + per-engine modules — reconstructed, SURVEY.md
§2.2; class names are [MED]-confidence reconstructions, aliased liberally).
This module wraps the functional engines in that ergonomic shape so a
pysvihmm user can switch with minimal edits:

    from pysvihmm_tpu.compat import VBHMM, SVIHMM
    m = VBHMM(obs, K=4).infer(maxit=50)
    m.elbo_history; m.var_tran; m.decode(); m.hamming_dist(z_true)

Engines:  VBHMM (hmmbatchcd) · SGDHMM (hmmbatchsgd) · SVIHMM (hmmsvi) ·
MetaObsHMM (hmmsgd_metaobs) · GibbsHMM (comparison sampler).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..data import synthetic  # noqa: F401  (re-export convenience)
from ..distributions import DiagonalGaussianNIG, GaussianNIW, MultinomialDirichlet
from ..engines import batch_sgd, batch_vb, gibbs, metaobs, svi
from ..engines.base import (
    decode as _decode,
    lower_bound,
    predictive_log_likelihood,
    viterbi_decode,
)
from ..eval.metrics import hamming_error
from ..models.hmm import HMMParams, init_params, make_prior, resolve_emission


class _HMMBase:
    """Shared ctor/accessors (reference ``VariationalHMMBase`` analog)."""

    def __init__(
        self,
        obs,
        K: int,
        *,
        emission: str | None = None,
        num_symbols: int | None = None,
        alpha_init: float = 1.0,
        alpha_tran: float = 1.0,
        seed: int = 0,
        **emission_kw,
    ):
        obs = jnp.asarray(obs)
        if obs.ndim == 1 or (obs.ndim == 2 and jnp.issubdtype(obs.dtype, jnp.integer)):
            obs = obs[None] if obs.ndim == 1 else obs
        elif obs.ndim == 2:
            obs = obs[None]  # single float sequence (T, D)
        self.obs = obs
        self.K = K

        if emission is None:
            emission = "multinomial" if jnp.issubdtype(obs.dtype, jnp.integer) else "gaussian"
        self.emission = resolve_emission(emission)
        if self.emission is MultinomialDirichlet:
            V = num_symbols if num_symbols is not None else int(obs.max()) + 1
            size_kw = dict(num_symbols=V)
        else:
            size_kw = dict(obs_dim=obs.shape[-1])
        self.prior = make_prior(
            K, self.emission, alpha_init=alpha_init, alpha_tran=alpha_tran,
            **size_kw, **emission_kw,
        )

        self.params = init_params(jax.random.PRNGKey(seed), self.prior, self.emission, obs)
        self.elbo_history: list[float] = []

    # reference-named accessors -------------------------------------------
    @property
    def var_init(self):
        return np.asarray(self.params.init)

    @property
    def var_tran(self):
        return np.asarray(self.params.trans)

    @property
    def var_emit(self):
        return jax.tree.map(np.asarray, self.params.emit)

    def lower_bound(self) -> float:
        return float(lower_bound(self.params, self.prior, self.emission, self.obs))

    def full_local_update(self):
        from ..engines.base import batch_local_step

        stats, gamma = batch_local_step(self.params, self.emission, self.obs)
        return np.asarray(gamma)

    def decode(self) -> np.ndarray:
        return np.asarray(_decode(self.params, self.emission, self.obs))

    def viterbi(self) -> np.ndarray:
        return np.asarray(viterbi_decode(self.params, self.emission, self.obs))

    def hamming_dist(self, true_states) -> float:
        return hamming_error(self.decode(), np.asarray(true_states), self.K)

    def pred_logprob(self, held_out) -> float:
        held = jnp.asarray(held_out)
        if held.ndim == self.obs.ndim - 1:
            held = held[None]
        n_obs = held.size if self.emission is MultinomialDirichlet else held[..., 0].size
        return float(
            predictive_log_likelihood(self.params, self.emission, held)
        ) / n_obs


class VBHMM(_HMMBase):
    """Batch coordinate-ascent VB (reference ``hmmbatchcd.VBHMM``)."""

    def infer(self, maxit: int = 100, tol: float = 1e-8, method: str = "auto",
              restarts: int = 1, seed: int = 0):
        # restarts > 1: vmapped best-of-N-seeds fit (device-resident, runs
        # the full maxit — the tol stop does not compose with a vmapped scan)
        if restarts > 1:
            params, elbos, best = batch_vb.fit_restarts(
                jax.random.PRNGKey(seed), self.prior, self.obs, self.emission,
                num_iters=maxit, num_restarts=restarts, method=method,
            )
            self.elbo_history = [float(x) for x in np.asarray(elbos[best])]
            self.params = params
            return self
        # host-side loop so the tolerance stop applies to the PARAMS as well
        # as the history (reference semantics: hmmbatchcd stops iterating at
        # tol); each step is one jitted coordinate-ascent update
        step = batch_vb.make_step(self.emission, method)
        params, elbos = self.params, []
        for _ in range(maxit):
            params, elbo = step(params, self.prior, self.obs)
            elbos.append(float(elbo))
            if len(elbos) > 1 and abs(elbos[-1] - elbos[-2]) < tol * abs(elbos[-2]):
                break
        self.elbo_history = elbos
        self.params = params
        return self


class SGDHMM(_HMMBase):
    """Full-data natural-gradient VB (reference ``hmmbatchsgd``)."""

    def __init__(self, obs, K, *, tau: float = 1.0, kappa: float = 0.6, **kw):
        super().__init__(obs, K, **kw)
        self.tau, self.kappa = tau, kappa

    def infer(self, maxit: int = 100, method: str = "auto"):
        params, elbos = batch_sgd.fit(
            self.params, self.prior, self.obs, self.emission,
            num_iters=maxit, tau=self.tau, kappa=self.kappa, method=method,
        )
        self.elbo_history = [float(x) for x in np.asarray(elbos)]
        self.params = params
        return self


class SVIHMM(_HMMBase):
    """SVI over buffered subchains of one long chain (reference ``hmmsvi.SVIHMM``)."""

    def __init__(
        self, obs, K, *, batch_size: int = 32, subchain_len: int = 50,
        buffer: int | str = 10, tau: float = 1.0, kappa: float = 0.6, **kw,
    ):
        super().__init__(obs, K, **kw)
        if self.obs.shape[0] != 1:
            raise ValueError("SVIHMM expects a single long chain; use MinibatchSVIHMM for sequence collections")
        self._auto_buffer = buffer == "auto"
        if self._auto_buffer:
            # paper §3.2 adaptive buffering: doubling test at the current
            # (initial) variational params; re-selected during infer() when
            # rebuffer_every is set (the paper adapts b to the CURRENT
            # params, which sharpen as the fit progresses)
            buffer = svi.select_buffer(
                self.params, self.obs[0], self.emission, subchain_len,
                jax.random.PRNGKey(0),
            )
        self.cfg = svi.SVIConfig(
            batch_size=batch_size, subchain_len=subchain_len, buffer=buffer,
            tau=tau, kappa=kappa,
        )

    def infer(self, maxit: int = 500, method: str = "auto", seed: int = 0,
              restarts: int = 1, rebuffer_every: int | None = None):
        """Run maxit SVI steps.

        rebuffer_every: with ``buffer="auto"``, re-run the paper-§3.2
        doubling test against the CURRENT variational params every this
        many steps and continue with the newly selected buffer (the
        natural-gradient schedule state carries across segments; each
        buffer change recompiles the step). Ignored for fixed buffers.
        """
        chain = self.obs[0]
        if restarts > 1:
            # vmapped best-of-N seeds, winner by exact full-chain ELBO
            state, elbos, best = svi.fit_restarts(
                jax.random.PRNGKey(seed), self.prior, chain, self.emission,
                self.cfg, maxit, num_restarts=restarts, method=method,
            )
            self.params = state.params
            self.elbo_history.append(float(elbos[best]))
            return self
        state = svi.init_state(self.params, jax.random.PRNGKey(seed))
        state = state._replace(step=jnp.asarray(len(self.elbo_history), jnp.int32))
        segment = maxit if not (self._auto_buffer and rebuffer_every) else rebuffer_every
        done = 0
        rekey = jax.random.PRNGKey(seed + 1)
        while done < maxit:
            n = min(segment, maxit - done)
            state, metrics = svi.fit(
                state, self.prior, chain, self.emission, self.cfg, n, method
            )
            self.elbo_history += [float(x) for x in np.asarray(metrics["noisy_elbo"])]
            done += n
            if done < maxit:
                rekey, k = jax.random.split(rekey)
                b = svi.select_buffer(
                    state.params, chain, self.emission,
                    self.cfg.subchain_len, k,
                )
                if b != self.cfg.buffer:
                    self.cfg = self.cfg._replace(buffer=b)
        self.params = state.params
        return self


class MinibatchSVIHMM(_HMMBase):
    """SVI over minibatches of whole sequences (sequence-collection regime)."""

    def __init__(self, obs, K, *, batch_size: int = 32, tau: float = 1.0,
                 kappa: float = 0.6, **kw):
        super().__init__(obs, K, **kw)
        self.cfg = svi.SVIConfig(batch_size=batch_size, tau=tau, kappa=kappa)

    def infer(self, maxit: int = 500, method: str = "auto", seed: int = 0):
        state = svi.init_state(self.params, jax.random.PRNGKey(seed))
        state, metrics = svi.fit_minibatch(
            state, self.prior, self.obs, self.emission, self.cfg, maxit, method
        )
        self.elbo_history += [float(x) for x in np.asarray(metrics["noisy_elbo"])]
        self.params = state.params
        return self


class MetaObsHMM(_HMMBase):
    """Parallel meta-observation SVI (reference ``hmmsgd_metaobs``)."""

    def __init__(self, obs, K, *, minibatch: int = 8, block_len: int = 100,
                 buffer: int = 10, tau: float = 1.0, kappa: float = 0.6, **kw):
        super().__init__(obs, K, **kw)
        if self.obs.shape[0] != 1:
            raise ValueError("MetaObsHMM expects a single long chain")
        self.cfg = metaobs.MetaObsConfig(
            minibatch=minibatch, block_len=block_len, buffer=buffer,
            tau=tau, kappa=kappa,
        )

    def infer(self, maxit: int = 500, method: str = "auto", seed: int = 0):
        chain = self.obs[0]
        state = svi.init_state(self.params, jax.random.PRNGKey(seed))
        state, metrics = metaobs.fit(
            state, self.prior, chain, self.emission, self.cfg, maxit, method
        )
        self.params = state.params
        self.elbo_history += [float(x) for x in np.asarray(metrics["noisy_elbo"])]
        return self


class GibbsHMM(_HMMBase):
    """Blocked Gibbs comparison sampler (FFBS + conjugate draws)."""

    def infer(self, maxit: int = 100, seed: int = 0):
        state = gibbs.init_state(
            jax.random.PRNGKey(seed), self.prior, self.emission, self.obs, self.K
        )
        state, metrics = gibbs.run(
            state, self.prior, self.obs, self.emission, self.K, maxit
        )
        self.state = state
        self.elbo_history += [float(x) for x in np.asarray(metrics["marginal_loglik"])]
        return self

    def decode(self) -> np.ndarray:
        if hasattr(self, "state"):
            return np.asarray(self.state.z)
        return super().decode()


# Reference module-name aliases.
hmmbatchcd = VBHMM
hmmbatchsgd = SGDHMM
hmmsvi = SVIHMM
hmmsgd_metaobs = MetaObsHMM

__all__ = [
    "VBHMM", "SGDHMM", "SVIHMM", "MinibatchSVIHMM", "MetaObsHMM", "GibbsHMM",
    "hmmbatchcd", "hmmbatchsgd", "hmmsvi", "hmmsgd_metaobs",
]
