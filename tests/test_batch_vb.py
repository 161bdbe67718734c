"""Batch coordinate-ascent VB engine tests (reference ``test_hmmbatchcd.py``
pattern, SURVEY.md §4): oracle parity, ELBO monotonicity, recovery.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset, gen_multinomial_dataset
from pysvihmm_tpu.distributions.emissions import GaussianNIW, MultinomialDirichlet
from pysvihmm_tpu.engines import batch_vb
from pysvihmm_tpu.engines.base import decode, lower_bound, predictive_log_likelihood
from pysvihmm_tpu.eval.metrics import hamming_error
from pysvihmm_tpu.models.hmm import init_params, make_prior
from pysvihmm_tpu.oracle.numpy_ref import BatchVBOracle


class TestGaussianBatchVB:
    def test_oracle_parity_and_monotone(self, enable_x64):
        """ELBO trajectory must match the float64 NumPy oracle to ~1e-9."""
        K, D, B, T = 4, 2, 10, 100
        obs, z_true, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, B, T)
        obs = obs.astype(jnp.float64)
        prior = make_prior(K, GaussianNIW, obs_dim=D, dtype=jnp.float64)
        params0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)

        orc = BatchVBOracle(
            np.array(obs), K,
            np.array(prior.init), np.array(prior.trans),
            np.array(prior.emit.mean), np.array(prior.emit.kappa),
            np.array(prior.emit.nu), np.array(prior.emit.psi),
        )
        orc.var_init = np.array(params0.init)
        orc.var_tran = np.array(params0.trans)
        orc.var_niw = tuple(np.array(x) for x in params0.emit)
        orc.infer(maxit=15, tol=0)

        _, elbos = batch_vb.fit(params0, prior, obs, GaussianNIW, num_iters=15)
        elbos = np.array(elbos)
        np.testing.assert_allclose(elbos, np.array(orc.elbo_history), rtol=1e-9)
        assert np.all(np.diff(elbos) > -1e-8), "coordinate-ascent ELBO must be monotone"

    def test_recovery_hamming(self):
        """On well-separated synthetic data the decode recovers the truth."""
        K, D, B, T = 4, 2, 20, 200
        obs, z_true, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(2), K, D, B, T, mean_scale=6.0, cov_scale=0.3
        )
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        best = 1.0
        for seed in range(3):
            params0 = init_params(jax.random.PRNGKey(seed), prior, GaussianNIW, obs)
            params, elbos = batch_vb.fit(params0, prior, obs, GaussianNIW, num_iters=60)
            zs = decode(params, GaussianNIW, obs)
            best = min(best, hamming_error(np.array(zs), np.array(z_true), K))
            if best < 0.05:
                break
        assert best < 0.05, f"hamming {best}"

    def test_elbo_monotone_f32(self):
        """Monotonicity also holds in float32 (the device compute dtype) within noise."""
        K, D, B, T = 4, 2, 10, 100
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, B, T)
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
        _, elbos = batch_vb.fit(params0, prior, obs, GaussianNIW, num_iters=30)
        elbos = np.array(elbos)
        drops = np.diff(elbos) / np.abs(elbos[:-1])
        assert np.all(drops > -1e-5), f"worst relative drop {drops.min()}"

    def test_assoc_method_same_fixed_point(self, enable_x64):
        K, D, B, T = 3, 2, 4, 60
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(3), K, D, B, T)
        obs = obs.astype(jnp.float64)
        prior = make_prior(K, GaussianNIW, obs_dim=D, dtype=jnp.float64)
        params0 = init_params(jax.random.PRNGKey(4), prior, GaussianNIW, obs)
        _, e1 = batch_vb.fit(params0, prior, obs, GaussianNIW, num_iters=10, method="scan")
        _, e2 = batch_vb.fit(params0, prior, obs, GaussianNIW, num_iters=10, method="assoc")
        np.testing.assert_allclose(np.array(e1), np.array(e2), rtol=1e-8)


class TestMultinomialBatchVB:
    def test_monotone_and_recovery(self):
        K, V, B, T = 3, 12, 20, 200
        obs, z_true, _ = gen_multinomial_dataset(
            jax.random.PRNGKey(5), K, V, B, T, concentration=0.2
        )
        prior = make_prior(K, MultinomialDirichlet, num_symbols=V)
        best = 1.0
        for seed in range(3):
            params0 = init_params(
                jax.random.PRNGKey(10 + seed), prior, MultinomialDirichlet
            )
            params, elbos = batch_vb.fit(
                params0, prior, obs, MultinomialDirichlet, num_iters=60
            )
            elbos = np.array(elbos)
            drops = np.diff(elbos) / np.abs(elbos[:-1])
            assert np.all(drops > -1e-5)
            zs = decode(params, MultinomialDirichlet, obs)
            best = min(best, hamming_error(np.array(zs), np.array(z_true), K))
            if best < 0.15:
                break
        assert best < 0.15, f"hamming {best}"

    def test_predictive_loglik_beats_uniform(self):
        K, V, B, T = 3, 12, 16, 150
        obs, _, _ = gen_multinomial_dataset(jax.random.PRNGKey(6), K, V, B, T)
        train, held = obs[:12], obs[12:]
        prior = make_prior(K, MultinomialDirichlet, num_symbols=V)
        params0 = init_params(jax.random.PRNGKey(7), prior, MultinomialDirichlet)
        params, _ = batch_vb.fit(params0, prior, train, MultinomialDirichlet, num_iters=40)
        pll = float(predictive_log_likelihood(params, MultinomialDirichlet, held))
        uniform = held.size * np.log(1.0 / V)
        assert pll > uniform


class TestFitRestarts:
    def test_selects_argmax_and_dominates_single_seed(self):
        """fit_restarts returns the argmax-final-ELBO restart's params and is
        at least as good as any single-seed run from the same key family."""
        K, D, B, T = 4, 2, 16, 150
        obs, z_true, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(2), K, D, B, T, mean_scale=6.0, cov_scale=0.3
        )
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        key = jax.random.PRNGKey(11)
        params, elbos, best = batch_vb.fit_restarts(
            key, prior, obs, GaussianNIW, num_iters=30, num_restarts=4
        )
        e = np.asarray(elbos)
        assert e.shape == (4, 30)
        assert int(best) == int(np.argmax(e[:, -1]))
        # the returned params ARE the winning restart: one more step from
        # them must continue that restart's trajectory (elbo >= its final)
        step = batch_vb.make_step(GaussianNIW)
        _, elbo_next = step(params, prior, obs)
        assert float(elbo_next) >= e[best, -1] - 1e-3 * abs(e[best, -1])
        # dominates each restart run individually (vmap == loop consistency)
        keys = jax.random.split(key, 4)
        for i, k in enumerate(keys):
            p0 = init_params(k, prior, GaussianNIW, obs)
            _, e_i = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=30)
            np.testing.assert_allclose(np.asarray(e_i), e[i], rtol=2e-4)
        assert e[best, -1] == e[:, -1].max()

    def test_compat_restarts(self):
        from pysvihmm_tpu.compat import VBHMM

        K, D, B, T = 4, 2, 12, 120
        obs, z_true, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(3), K, D, B, T, mean_scale=6.0, cov_scale=0.3
        )
        m = VBHMM(obs, K=K).infer(maxit=25, restarts=3, seed=5)
        assert len(m.elbo_history) == 25
        assert hamming_error(np.asarray(m.decode()), np.asarray(z_true), K) < 0.1


class TestDiagGaussianBatchVB:
    def test_monotone_and_recovery(self):
        from pysvihmm_tpu.data.synthetic import gen_diag_gaussian_dataset
        from pysvihmm_tpu.distributions.emissions import DiagonalGaussianNIG

        K, D = 4, 3
        obs, z_true, true_params = gen_diag_gaussian_dataset(
            jax.random.PRNGKey(11), K, D, num_seqs=20, T=150, mean_scale=6.0
        )
        prior = make_prior(K, DiagonalGaussianNIG, obs_dim=D)
        params = init_params(jax.random.PRNGKey(1), prior, DiagonalGaussianNIG, obs)
        params, elbos = batch_vb.fit(params, prior, obs, DiagonalGaussianNIG, num_iters=40)
        e = np.array(elbos)
        assert np.all(np.diff(e) >= -np.abs(e[1:]) * 1e-5 - 1e-2), "ELBO not monotone"
        z_hat = np.array(decode(params, DiagonalGaussianNIG, obs))
        assert hamming_error(z_hat, np.array(z_true), K) < 0.05
        # held-out sequences from the SAME true HMM beat a unit-Gaussian baseline
        from pysvihmm_tpu.data.synthetic import gen_data

        held, _ = gen_data(
            jax.random.PRNGKey(12), true_params, DiagonalGaussianNIG,
            num_seqs=4, T=100,
        )
        pll = float(
            predictive_log_likelihood(params, DiagonalGaussianNIG, held)
        )
        base = float(np.sum(-0.5 * (np.log(2 * np.pi) + np.array(held) ** 2)))
        assert pll > base

    def test_exact_predictive_close_to_plugin(self):
        from pysvihmm_tpu.data.synthetic import gen_diag_gaussian_dataset
        from pysvihmm_tpu.distributions.emissions import DiagonalGaussianNIG

        K, D = 3, 2
        obs, _, _ = gen_diag_gaussian_dataset(
            jax.random.PRNGKey(21), K, D, num_seqs=10, T=200, mean_scale=5.0
        )
        prior = make_prior(K, DiagonalGaussianNIG, obs_dim=D)
        params = init_params(jax.random.PRNGKey(2), prior, DiagonalGaussianNIG, obs)
        params, _ = batch_vb.fit(params, prior, obs, DiagonalGaussianNIG, num_iters=30)
        held = obs[:2]
        exact = float(
            predictive_log_likelihood(params, DiagonalGaussianNIG, held, exact=True)
        )
        plug = float(predictive_log_likelihood(params, DiagonalGaussianNIG, held))
        # with T=2000 training points the Student-t predictive ~ the plug-in
        assert abs(exact - plug) / abs(plug) < 0.05
