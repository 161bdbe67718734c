"""Poisson-Gamma emission family (extension beyond the reference's
Gaussian/Multinomial pair): exactness of the conjugate algebra against
closed forms and scipy, engine integration on every FB path, and
end-to-end recovery on synthetic count data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats as sps
from scipy.special import digamma as sp_digamma, gammaln as sp_gammaln

from pysvihmm_tpu.data.synthetic import gen_poisson_dataset
from pysvihmm_tpu.distributions import GammaP, PoissonGamma, poisson
from pysvihmm_tpu.models.hmm import init_params, make_prior, resolve_emission


def _rand_q(key, K, D):
    ka, kb = jax.random.split(key)
    return GammaP(
        a=jax.random.uniform(ka, (K, D), minval=0.5, maxval=8.0),
        b=jax.random.uniform(kb, (K, D), minval=0.2, maxval=4.0),
    )


class TestAlgebra:
    def test_ell_closed_form(self):
        """ELL == sum_d (y E[log lam] - E[lam] - log y!) with the scipy
        digamma, and the feature factorization reproduces it exactly."""
        q = _rand_q(jax.random.PRNGKey(0), 3, 2)
        y = jnp.array([[0.0, 3.0], [5.0, 1.0]])
        ell = np.array(poisson.expected_log_likelihood(q, y))
        a, b = np.array(q.a, np.float64), np.array(q.b, np.float64)
        yn = np.array(y, np.float64)
        e_log = sp_digamma(a) - np.log(b)
        ref = (
            yn[:, None, :] * e_log - a / b - sp_gammaln(yn + 1.0)[:, None, :]
        ).sum(-1)
        np.testing.assert_allclose(ell, ref, rtol=2e-5)
        feats = poisson.ell_features(y)
        W = poisson.ell_feature_matrix(q)
        np.testing.assert_allclose(np.array(feats @ W), ell, rtol=2e-5)

    def test_conjugacy_and_natgrad_identity(self):
        """posterior == rho=1/scale=1 nat_grad_step (exact conjugate blend)."""
        q = _rand_q(jax.random.PRNGKey(1), 4, 3)
        gamma = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(2), (50, 4)))
        y = jnp.abs(jax.random.normal(jax.random.PRNGKey(3), (50, 3))) * 4
        stats = poisson.suff_stats(gamma, y)
        post = poisson.posterior(q, stats)
        ng = poisson.nat_grad_step(q, q, stats, 1.0, 1.0)
        for pa, na in zip(post, ng):
            np.testing.assert_allclose(np.array(pa), np.array(na), rtol=1e-6)

    def test_kl(self):
        """KL(p, p) = 0; KL >= 0; matches scipy's gamma KL via entropy
        cross-check on a handful of draws."""
        p = _rand_q(jax.random.PRNGKey(4), 5, 2)
        np.testing.assert_allclose(np.array(poisson.kl(p, p)), 0.0, atol=1e-5)
        q = _rand_q(jax.random.PRNGKey(5), 5, 2)
        assert (np.array(poisson.kl(q, p)) >= -1e-6).all()
        # MC validation of one entry
        a_q, b_q = float(q.a[0, 0]), float(q.b[0, 0])
        a_p, b_p = float(p.a[0, 0]), float(p.b[0, 0])
        xs = sps.gamma.rvs(a_q, scale=1.0 / b_q, size=200_000, random_state=0)
        mc = np.mean(
            sps.gamma.logpdf(xs, a_q, scale=1.0 / b_q)
            - sps.gamma.logpdf(xs, a_p, scale=1.0 / b_p)
        )
        kl00 = float(poisson.kl(GammaP(q.a[:1, :1], q.b[:1, :1]),
                                GammaP(p.a[:1, :1], p.b[:1, :1]))[0])
        np.testing.assert_allclose(kl00, mc, rtol=3e-2)

    def test_predictive_is_negative_binomial(self):
        """Exact Gamma-Poisson predictive == scipy nbinom(r=a, p=b/(b+1))."""
        q = _rand_q(jax.random.PRNGKey(6), 3, 2)
        y = jnp.array([[0.0, 2.0], [7.0, 1.0], [3.0, 3.0]])
        mine = np.array(poisson.predictive_log_likelihood(q, y))
        a, b = np.array(q.a, np.float64), np.array(q.b, np.float64)
        yn = np.array(y, np.float64)
        ref = sps.nbinom.logpmf(
            yn[:, None, :], a[None], (b / (b + 1.0))[None]
        ).sum(-1)
        np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-5)


class TestEngineIntegration:
    @pytest.fixture(scope="class")
    def dataset(self):
        obs, z, tp = gen_poisson_dataset(
            jax.random.PRNGKey(0), 4, 3, 24, 200, rate_scale=25.0
        )
        return obs, z, tp

    def test_registry(self):
        assert resolve_emission("poisson") is PoissonGamma

    def test_estep_paths_agree(self, dataset):
        """scan and the forward-backward kernel (interpreter) produce the
        same stats and smoothed marginals."""
        from pysvihmm_tpu.engines.base import batch_local_step

        obs, _, _ = dataset
        obs = obs[:8, :64]
        prior = make_prior(4, PoissonGamma, obs_dim=3)
        params = init_params(jax.random.PRNGKey(1), prior, PoissonGamma, obs)
        outs = {
            m: batch_local_step(params, PoissonGamma, obs, m, interpret=m == "pallas")
            for m in ("scan", "pallas")
        }
        ref_s, ref_logc = outs["scan"]
        for m in ("pallas",):
            s, logc = outs[m]
            np.testing.assert_allclose(np.array(logc), np.array(ref_logc),
                                       rtol=2e-4, atol=2e-4)
            for a, b in zip(jax.tree.leaves(ref_s), jax.tree.leaves(s)):
                np.testing.assert_allclose(np.array(a), np.array(b),
                                           rtol=2e-3, atol=2e-3)

    def test_batch_vb_recovers(self, dataset):
        """VB on well-separated count data: ELBO climbs to a stable value
        and decode lands within 1.5x the true-params Viterbi error."""
        from pysvihmm_tpu import messages
        from pysvihmm_tpu.engines import batch_vb
        from pysvihmm_tpu.engines.base import decode
        from pysvihmm_tpu.eval.metrics import hamming_error

        obs, z, tp = dataset
        prior = make_prior(4, PoissonGamma, obs_dim=3)
        params, elbos, best = batch_vb.fit_restarts(
            jax.random.PRNGKey(2), prior, obs, PoissonGamma,
            num_restarts=4, num_iters=50,
        )
        e = np.array(elbos)[int(best)]
        assert np.isfinite(e).all() and e[-1] > e[0]
        ll = PoissonGamma.point_log_likelihood(tp.theta, obs)
        z_bayes = jax.vmap(
            lambda l: messages.viterbi(jnp.log(tp.pi), jnp.log(tp.A), l)
        )(ll)
        bayes = float(hamming_error(z_bayes, z, 4))
        ham = float(hamming_error(decode(params, PoissonGamma, obs), z, 4))
        assert ham <= max(1.5 * bayes, 0.05), (ham, bayes)

    def test_svi_and_gibbs_smoke(self, dataset):
        """One SVI minibatch fit and a short Gibbs chain stay finite and
        produce sane posteriors."""
        from pysvihmm_tpu.engines import gibbs, svi

        obs, _, _ = dataset
        prior = make_prior(4, PoissonGamma, obs_dim=3)
        p0 = init_params(jax.random.PRNGKey(3), prior, PoissonGamma, obs)
        state = svi.init_state(p0, jax.random.PRNGKey(4))
        cfg = svi.SVIConfig(batch_size=8)
        state, metrics = svi.fit_minibatch(state, prior, obs, PoissonGamma,
                                           cfg, num_steps=20)
        params = state.params
        assert np.isfinite(np.array(metrics["noisy_elbo"])).all()
        assert (np.array(params.emit.a) > 0).all() and (np.array(params.emit.b) > 0).all()
        gstate = gibbs.init_state(jax.random.PRNGKey(5), prior, PoissonGamma,
                                  obs[:4], 4)
        gstate, gmetrics = gibbs.run(gstate, prior, obs[:4], PoissonGamma, 4,
                                     num_sweeps=3)
        assert all(np.isfinite(np.array(l)).all()
                   for l in jax.tree.leaves(gstate.theta))

    def test_compat_class(self, dataset):
        """The reference-shaped class API accepts emission='poisson'."""
        from pysvihmm_tpu.compat import VBHMM

        obs, z, _ = dataset
        m = VBHMM(obs[:8], K=4, emission="poisson")
        m.infer(maxit=10)
        assert np.isfinite(np.array(m.elbo_history)).all()
