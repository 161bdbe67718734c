"""SVI engine tests (reference ``test_hmmsvi.py`` pattern, SURVEY.md §4)
plus the estimator property tests SURVEY.md §7 calls out as "hard parts":
unbiased scaling and the rho=1 / full-batch == coordinate-ascent identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu.distributions import GaussianNIW
from pysvihmm_tpu.engines import batch_sgd, batch_vb, metaobs, svi
from pysvihmm_tpu.engines.base import batch_local_step, decode
from pysvihmm_tpu.eval.metrics import hamming_error
from pysvihmm_tpu.models.hmm import init_params, make_prior


class TestWindowPlanning:
    """The windowed engines' shared planner (messages.plan_window): the
    window is the kept subchain plus a buffer on each side, W = L + 2b, on
    every backend, and "auto" picks the E-step by backend."""

    @pytest.mark.parametrize("cuda,method", [(False, "scan"), (True, "pallas")])
    def test_default_window_geometry(self, monkeypatch, cuda, method):
        from pysvihmm_tpu import messages

        monkeypatch.setattr(messages, "on_cuda", lambda: cuda)
        assert messages.plan_window("auto", 50, 10) == (method, 70, 10)

    def test_explicit_method_passes_through(self):
        from pysvihmm_tpu import messages

        assert messages.plan_window("pallas", 50, 10) == ("pallas", 70, 10)
        assert messages.plan_window("blocked", 30, 0) == ("blocked", 30, 0)

    def test_make_step_runs_with_padded_window(self):
        # end-to-end: the default config (W=70) goes through make_step's
        # plan_window path and produces a finite update on the CPU
        K, D, T = 3, 2, 400
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, 1, T)
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, chain[None])
        cfg = svi.SVIConfig(batch_size=4, subchain_len=50, buffer=10)
        step = svi.make_step(GaussianNIW, cfg, T)
        st = svi.init_state(params, jax.random.PRNGKey(2))
        st2, metrics = step(st, prior, chain)
        assert jnp.isfinite(metrics["noisy_elbo"])
        assert int(st2.step) == 1

    def test_kernel_method_needs_cuda(self):
        # an explicit kernel request on the CPU fails instead of running
        # the interpreter behind the caller's back
        K, D, T = 3, 2, 200
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, 1, T)
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
        cfg = svi.SVIConfig(batch_size=4, subchain_len=50, buffer=10)
        step = svi.make_step(GaussianNIW, cfg, T, method="pallas")
        with pytest.raises(ValueError, match="CUDA"):
            step(svi.init_state(params, jax.random.PRNGKey(2)), prior, obs[0])


class TestScalingUnbiasedness:
    def test_subchain_stats_unbiased(self, enable_x64):
        """Averaged over many minibatches at fixed params, the scaled SVI
        stats converge to the full-chain stats (interior positions)."""
        K, D, T = 3, 2, 400
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, 1, T)
        chain = obs[0].astype(jnp.float64)
        prior = make_prior(K, GaussianNIW, obs_dim=D, dtype=jnp.float64)
        params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, chain)

        # full-chain stats at fixed params
        full_stats, _ = batch_local_step(params, GaussianNIW, chain[None])

        cfg = svi.SVIConfig(batch_size=8, subchain_len=50, buffer=20, tau=1.0, kappa=0.0)
        B, L, b = cfg.batch_size, cfg.subchain_len, cfg.buffer
        scale_trans = (T - 1.0) / (B * (L - 1))
        scale_emit = T / (B * L)

        # re-create the stats computation from the step internals by running
        # the estimator many times with rho ~ 0 so params stay fixed? Instead
        # sample minibatches manually with the same machinery.
        from pysvihmm_tpu import messages
        from pysvihmm_tpu.models.hmm import emission_flat_stats, expected_log_params

        log_pi, log_A = expected_log_params(params)
        W = L + 2 * b
        num_starts = T - L + 1
        rng = np.random.default_rng(0)

        # All reps' minibatches in ONE batched device call: gather every
        # window (reps*B, W, D) and mask at once; the accumulated average
        # is linear, so summing the flat batch / reps is identical to the
        # per-rep accumulation loop.
        reps = 150
        starts = rng.integers(0, num_starts, size=reps * B)
        ws = np.clip(starts - b, 0, T - W)
        offs = starts - ws
        wins = jnp.asarray(np.array(chain))[jnp.asarray(ws)[:, None] + jnp.arange(W)]
        pos = np.arange(W)[None, :]
        maskf = jnp.array(
            ((pos >= offs[:, None]) & (pos < offs[:, None] + L)).astype(np.float64)
        )
        ll = GaussianNIW.expected_log_likelihood(params.emit, wins)
        fb = jax.vmap(
            lambda l, w: messages.e_step(log_pi, log_A, l, weights=w)
        )(ll, maskf)
        gamma_w = fb.gamma * maskf[..., None]
        es = emission_flat_stats(GaussianNIW, params.emit, gamma_w, wins)
        acc_trans = scale_trans * np.array(jnp.sum(fb.trans_stats, 0)) / reps
        acc_n = scale_emit * np.array(es.n) / reps

        # interior coverage is uniform; edges (first/last L-1 positions) are
        # covered less — compare at 5% tolerance which absorbs that + MC noise
        np.testing.assert_allclose(
            acc_trans.sum(), np.array(full_stats.trans).sum(), rtol=0.05
        )
        np.testing.assert_allclose(acc_n, np.array(full_stats.emit.n), rtol=0.1)
        np.testing.assert_allclose(
            acc_trans, np.array(full_stats.trans), rtol=0.15, atol=0.5
        )

    def test_minibatch_rho1_fullbatch_equals_batch_cd(self, enable_x64):
        """B=N sequences, rho=1 => one SVI step == one coordinate-ascent step."""
        K, D, N, T = 3, 2, 6, 80
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(2), K, D, N, T)
        obs = obs.astype(jnp.float64)
        prior = make_prior(K, GaussianNIW, obs_dim=D, dtype=jnp.float64)
        params0 = init_params(jax.random.PRNGKey(3), prior, GaussianNIW, obs)

        cd_step = batch_vb.make_step(GaussianNIW)
        cd_params, _ = cd_step(params0, prior, obs)

        cfg = svi.SVIConfig(batch_size=N, tau=1.0, kappa=0.0)  # rho = 1
        mb_step = svi.make_minibatch_step(GaussianNIW, cfg, num_seqs=N)
        state = svi.init_state(params0, jax.random.PRNGKey(4))
        # force the "minibatch" to be every sequence exactly once: with B=N and
        # sampling with replacement this isn't guaranteed, so instead check the
        # equivalent identity through batch_sgd (full data, rho=1):
        sgd_params, _ = batch_sgd.fit(
            params0, prior, obs, GaussianNIW, num_iters=1, tau=1.0, kappa=0.0
        )
        for a, b in zip(jax.tree.leaves(cd_params), jax.tree.leaves(sgd_params)):
            np.testing.assert_allclose(np.array(a), np.array(b), rtol=1e-8)


class TestSVIConvergence:
    def test_single_chain_convergence(self):
        """BASELINE config-2 regime (scaled down): SVI on one long chain
        recovers the states as well as batch VB does."""
        K, D, T = 4, 2, 3000
        obs, z_true, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(5), K, D, 1, T, mean_scale=6.0, cov_scale=0.3
        )
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params0 = init_params(jax.random.PRNGKey(6), prior, GaussianNIW, chain)
        cfg = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10, tau=10.0, kappa=0.6)
        state = svi.init_state(params0, jax.random.PRNGKey(7))
        state, metrics = svi.fit(state, prior, chain, GaussianNIW, cfg, num_steps=300)
        zs = decode(state.params, GaussianNIW, chain[None])
        err = hamming_error(np.array(zs), np.array(z_true), K)
        assert err < 0.05, f"hamming {err}"

    def test_noisy_elbo_improves(self):
        K, D, T = 4, 2, 2000
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(8), K, D, 1, T,
                                         mean_scale=6.0, cov_scale=0.3)
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params0 = init_params(jax.random.PRNGKey(9), prior, GaussianNIW, chain)
        cfg = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10, tau=10.0, kappa=0.6)
        state = svi.init_state(params0, jax.random.PRNGKey(10))
        state, metrics = svi.fit(state, prior, chain, GaussianNIW, cfg, num_steps=200)
        ne = np.array(metrics["noisy_elbo"])
        assert np.mean(ne[-50:]) > np.mean(ne[:20])


class TestAdaptiveBuffer:
    def test_select_buffer_doubling(self):
        """Paper §3.2 doubling test: fast-mixing chains need small buffers;
        a tighter tolerance can only grow the chosen b."""
        K, D, T = 4, 2, 2000
        obs, _, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(20), K, D, 1, T, mean_scale=6.0, cov_scale=0.3
        )
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params = init_params(jax.random.PRNGKey(21), prior, GaussianNIW, chain)

        b_loose = svi.select_buffer(
            params, chain, GaussianNIW, 50, jax.random.PRNGKey(22), tol=1e-2
        )
        b_tight = svi.select_buffer(
            params, chain, GaussianNIW, 50, jax.random.PRNGKey(22), tol=1e-6
        )
        assert 1 <= b_loose <= 64
        assert b_tight >= b_loose

    def test_compat_auto_buffer(self):
        from pysvihmm_tpu.compat import SVIHMM

        K, D, T = 3, 2, 1500
        obs, _, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(23), K, D, 1, T, mean_scale=6.0, cov_scale=0.3
        )
        m = SVIHMM(obs, K=K, buffer="auto", subchain_len=40)
        assert isinstance(m.cfg.buffer, int) and m.cfg.buffer >= 1

    def test_compat_periodic_rebuffer(self):
        # paper §3.2: b adapts to the CURRENT params; with rebuffer_every the
        # fit re-selects mid-run and the schedule state carries across
        # segments (elbo history = full maxit, step counter monotone)
        from pysvihmm_tpu.compat import SVIHMM

        K, D, T = 3, 2, 1500
        obs, _, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(23), K, D, 1, T, mean_scale=6.0, cov_scale=0.3
        )
        m = SVIHMM(obs, K=K, buffer="auto", subchain_len=40, batch_size=8)
        m.infer(maxit=30, rebuffer_every=10, method="scan")
        assert len(m.elbo_history) == 30
        assert isinstance(m.cfg.buffer, int) and m.cfg.buffer >= 1
        assert np.isfinite(m.elbo_history).all()


class TestMetaObs:
    def test_block_svi_convergence(self):
        K, D, T = 4, 2, 3000
        obs, z_true, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(11), K, D, 1, T, mean_scale=6.0, cov_scale=0.3
        )
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params0 = init_params(jax.random.PRNGKey(12), prior, GaussianNIW, chain)
        cfg = metaobs.MetaObsConfig(minibatch=6, block_len=100, buffer=10, tau=10.0, kappa=0.6)
        state = svi.init_state(params0, jax.random.PRNGKey(13))
        state, _ = metaobs.fit(state, prior, chain, GaussianNIW, cfg, num_steps=250)
        zs = decode(state.params, GaussianNIW, chain[None])
        err = hamming_error(np.array(zs), np.array(z_true), K)
        assert err < 0.05, f"hamming {err}"

    def test_config_validation(self):
        cfg = metaobs.MetaObsConfig(minibatch=4, block_len=64, buffer=8)
        with pytest.raises(ValueError, match="multiple"):
            metaobs.make_step(GaussianNIW, cfg, chain_len=1000)
        with pytest.raises(ValueError, match="minibatch"):
            metaobs.make_step(
                GaussianNIW,
                metaobs.MetaObsConfig(minibatch=40, block_len=100, buffer=8),
                chain_len=1000,
            )


class TestMinibatchSVI:
    def test_many_sequence_convergence(self):
        K, D, N, T = 4, 2, 64, 100
        obs, z_true, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(14), K, D, N, T, mean_scale=6.0, cov_scale=0.3
        )
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params0 = init_params(jax.random.PRNGKey(15), prior, GaussianNIW, obs)
        cfg = svi.SVIConfig(batch_size=8, tau=5.0, kappa=0.6)
        state = svi.init_state(params0, jax.random.PRNGKey(16))
        state, _ = svi.fit_minibatch(state, prior, obs, GaussianNIW, cfg, 400)
        zs = decode(state.params, GaussianNIW, obs)
        err = hamming_error(np.array(zs), np.array(z_true), K)
        assert err < 0.05, f"hamming {err}"


class TestDiagGaussianSVI:
    def test_single_chain_convergence_diag(self):
        """The SVI engine is emission-family-generic: converges with
        DiagonalGaussianNIG emissions (per-dim NIG natural-gradient steps)."""
        from pysvihmm_tpu.data.synthetic import gen_diag_gaussian_dataset
        from pysvihmm_tpu.distributions import DiagonalGaussianNIG

        K, D, T = 4, 2, 3000
        obs, z_true, _ = gen_diag_gaussian_dataset(
            jax.random.PRNGKey(5), K, D, 1, T, mean_scale=6.0, var_scale=0.3
        )
        chain = obs[0]
        prior = make_prior(K, DiagonalGaussianNIG, obs_dim=D)
        params0 = init_params(jax.random.PRNGKey(16), prior, DiagonalGaussianNIG, chain)
        cfg = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10, tau=10.0, kappa=0.6)
        state = svi.init_state(params0, jax.random.PRNGKey(17))
        state, _ = svi.fit(state, prior, chain, DiagonalGaussianNIG, cfg, num_steps=300)
        zs = decode(state.params, DiagonalGaussianNIG, chain[None])
        err = hamming_error(np.array(zs), np.array(z_true), K)
        assert err < 0.05, f"hamming {err}"


class TestSVIRestarts:
    def test_restarts_dominate_and_select_argmax(self):
        """fit_restarts: the winning restart's exact ELBO is the argmax, and
        best-of-8 is at least as good as the plain seed-0 run (the regime
        from TestDiagGaussianSVI's hard-data cousin where single seeds merge
        states)."""
        K, D, T = 4, 2, 2000
        obs, z_true, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(15), K, D, 1, T, mean_scale=6.0, cov_scale=0.3
        )
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        cfg = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10,
                            tau=10.0, kappa=0.6)
        state, elbos, best = svi.fit_restarts(
            jax.random.PRNGKey(0), prior, chain, GaussianNIW, cfg,
            num_steps=300, num_restarts=6,
        )
        elbos = np.array(elbos)
        assert int(best) == int(np.argmax(elbos))
        from pysvihmm_tpu.engines.base import lower_bound

        got = float(lower_bound(state.params, prior, GaussianNIW, chain[None]))
        np.testing.assert_allclose(got, elbos[int(best)], rtol=1e-5)
        # the winner decodes the chain well: single seeds merge states on
        # this data (hamming ~0.23); the restart winner sits at the data's
        # irreducible state-overlap level (~0.06)
        zs = decode(state.params, GaussianNIW, chain[None])
        assert hamming_error(np.array(zs), np.array(z_true), K) < 0.1
