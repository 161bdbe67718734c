"""Fault-tolerant trainer + elastic step-size tests (BASELINE config 5
subsystems: restart recovery and adaptive rho)."""

import jax
import jax.numpy as jnp
import numpy as np

from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset, gen_multinomial_dataset
from pysvihmm_tpu.distributions import GaussianNIW, MultinomialDirichlet
from pysvihmm_tpu.engines import svi, trainer
from pysvihmm_tpu.engines.base import decode, predictive_log_likelihood
from pysvihmm_tpu.eval.metrics import hamming_error
from pysvihmm_tpu.models.hmm import init_params, make_prior


def _chain_problem(seed=5, K=4, D=2, T=2000):
    obs, z_true, _ = gen_gaussian_dataset(
        jax.random.PRNGKey(seed), K, D, 1, T, mean_scale=6.0, cov_scale=0.3
    )
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params0 = init_params(jax.random.PRNGKey(seed + 1), prior, GaussianNIW, obs[0])
    return obs[0], z_true[0], prior, params0


class TestTrainer:
    def test_restart_resumes_from_checkpoint(self, tmp_path):
        chain, z_true, prior, params0 = _chain_problem()
        cfg = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10, tau=10.0)
        step = svi.make_step(GaussianNIW, cfg, chain_len=chain.shape[0])
        d = str(tmp_path)

        s = svi.init_state(params0, jax.random.PRNGKey(7))
        s = trainer.train(step, s, prior, chain, 120, checkpoint_dir=d, checkpoint_every=40)
        assert int(s.step) == 120

        # "crash" and restart with a fresh state object: must resume, not redo
        s2 = svi.init_state(params0, jax.random.PRNGKey(7))
        s2 = trainer.train(step, s2, prior, chain, 200, checkpoint_dir=d, checkpoint_every=40)
        assert int(s2.step) == 200
        err = hamming_error(
            np.asarray(decode(s2.params, GaussianNIW, chain[None])), np.asarray(z_true), 4
        )
        assert err < 0.05


class TestStreamedTrainer:
    def _setup(self, tmp_path, N=64, T=32, D=2, K=3, B=8):
        from pysvihmm_tpu.data.loader import ShardedSequenceLoader
        from pysvihmm_tpu.parallel import make_dp_streamed_svi_step, make_mesh

        obs, _, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(20), K, D, N, T, mean_scale=6.0, cov_scale=0.3
        )
        arr = np.asarray(obs, np.float32)
        path = str(tmp_path / "corpus.npy")
        np.save(path, arr)
        mesh = make_mesh()
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        p0 = init_params(jax.random.PRNGKey(21), prior, GaussianNIW, obs)
        cfg = svi.SVIConfig(batch_size=B, tau=5.0, kappa=0.6, adaptive=True)
        step = make_dp_streamed_svi_step(GaussianNIW, cfg, num_seqs=N, mesh=mesh)
        loader = ShardedSequenceLoader.from_npy(path, mesh, batch_per_host=B, seed=3)
        return prior, p0, step, loader

    def test_stream_is_deterministic_and_resumable(self, tmp_path):
        prior, p0, step, loader = self._setup(tmp_path)
        a = [np.asarray(b) for _, b in zip(range(13), loader.stream(0))]
        b = [np.asarray(b) for _, b in zip(range(13), loader.stream(0))]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        # resuming at step 5 reproduces the tail, including across the
        # epoch boundary (64 seqs / B=8 -> 8 batches/epoch)
        c = [np.asarray(b) for _, b in zip(range(8), loader.stream(5))]
        for x, y in zip(a[5:], c):
            np.testing.assert_array_equal(x, y)

    def test_streamed_kill_resume_bitexact(self, tmp_path):
        """A run killed mid-corpus and restarted from its checkpoint must
        land on the SAME final state as an uninterrupted run: the loader
        position is a pure function of the checkpointed step counter, and
        schedule/adaptive state ride in the checkpoint."""
        prior, p0, step, loader = self._setup(tmp_path)
        key = jax.random.PRNGKey(22)

        # uninterrupted reference: 20 steps, no checkpointing
        ref = svi.init_state(p0, key, adaptive=True)
        it = loader.stream(0)
        for _ in range(20):
            ref, _ = step(ref, prior, next(it))

        # "preempted" run: checkpoint every 4, killed after step 11
        d = str(tmp_path / "ckpt")
        s = svi.init_state(p0, key, adaptive=True)
        s = trainer.train_streamed(
            step, s, prior, loader, 11, checkpoint_dir=d, checkpoint_every=4
        )
        # restart from a FRESH state object: resume must pick up ckpt_11
        s2 = svi.init_state(p0, key, adaptive=True)
        s2 = trainer.train_streamed(
            step, s2, prior, loader, 20, checkpoint_dir=d, checkpoint_every=4
        )
        assert int(s2.step) == 20
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(s2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestAdaptiveStepSize:
    def test_adaptive_svi_converges(self):
        chain, z_true, prior, params0 = _chain_problem(seed=9)
        cfg = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10, adaptive=True)
        state = svi.init_state(params0, jax.random.PRNGKey(8), adaptive=True)
        state, metrics = svi.fit(state, prior, chain, GaussianNIW, cfg, num_steps=250)
        rhos = np.asarray(metrics["rho"])
        err = hamming_error(
            np.asarray(decode(state.params, GaussianNIW, chain[None])), np.asarray(z_true), 4
        )
        assert err < 0.05, f"hamming {err}"
        # elastic rho must actually adapt (decay from its early values)
        assert np.mean(rhos[-20:]) < np.mean(rhos[:20])


class TestMultinomialSVI:
    def test_config3_discrete_svi_with_predll(self):
        """BASELINE config 3 (scaled): multinomial-emission SVI + held-out
        predictive log-likelihood beating the uniform baseline."""
        K, V, T = 6, 30, 6000
        obs, z_true, _ = gen_multinomial_dataset(
            jax.random.PRNGKey(12), K, V, 1, T, concentration=0.08
        )
        chain, held = obs[0][:5000], obs[0][5000:]
        prior = make_prior(K, MultinomialDirichlet, num_symbols=V)
        params0 = init_params(jax.random.PRNGKey(13), prior, MultinomialDirichlet)
        cfg = svi.SVIConfig(batch_size=16, subchain_len=100, buffer=20, tau=10.0, kappa=0.6)
        state = svi.init_state(params0, jax.random.PRNGKey(14))
        state, _ = svi.fit(state, prior, chain, MultinomialDirichlet, cfg, num_steps=600)
        pll = float(
            predictive_log_likelihood(state.params, MultinomialDirichlet, held[None])
        )
        # far above the uniform baseline (the decisive quality signal here;
        # per-state recovery on near-symmetric multinomials is init-limited
        # for every engine incl. the reference's — see batch-VB comparisons)
        assert pll > 0.8 * held.size * np.log(1.0 / V)
        err = hamming_error(
            np.asarray(decode(state.params, MultinomialDirichlet, chain[None])),
            np.asarray(z_true[0][:5000]),
            K,
        )
        assert err < 0.3, f"hamming {err}"
