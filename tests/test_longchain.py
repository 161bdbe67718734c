"""Long-chain path tests: blocked (time-tiled) FB equals the sequential scan
on every shape/padding case, and handles a T=100k chain with bounded memory
(BASELINE config 4, scaled for CPU CI). Time-sharded FB (context-parallel
analog, SURVEY.md §2.4) must match the single-device scan on a virtual mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysvihmm_tpu import messages
from pysvihmm_tpu.messages.blocked import forward_backward_blocked
from pysvihmm_tpu.messages.time_sharded import time_sharded_forward_backward
from pysvihmm_tpu.parallel.data_parallel import make_mesh


rng = np.random.default_rng(11)


def problem(T, K):
    return (
        jnp.array(np.log(rng.dirichlet(np.ones(K)))),
        jnp.array(np.log(rng.dirichlet(np.ones(K), size=K))),
        jnp.array(rng.normal(size=(T, K)) * 2.0),
    )


class TestBlockedFB:
    @pytest.mark.parametrize("T,S", [(40, 8), (37, 8), (100, 256), (2, 4), (257, 64)])
    def test_matches_scan_all_shapes(self, T, S, enable_x64):
        log_pi, log_A, ll = problem(T, 5)
        w = jnp.array((rng.uniform(size=T) > 0.3).astype(np.float64))
        a = messages.forward_backward(log_pi, log_A, ll, w)
        b = forward_backward_blocked(log_pi, log_A, ll, w, block_size=S)
        np.testing.assert_allclose(np.array(b.gamma), np.array(a.gamma), atol=1e-12)
        np.testing.assert_allclose(float(b.log_z), float(a.log_z), rtol=1e-12)
        np.testing.assert_allclose(
            np.array(b.trans_stats), np.array(a.trans_stats), atol=1e-11
        )
        np.testing.assert_allclose(np.array(b.log_c), np.array(a.log_c), atol=1e-11)

    def test_long_chain_f32(self):
        """T=20k single chain in f32: logZ agrees with scan to float tolerance."""
        T, Ks = 20_000, 8
        log_pi, log_A, ll = problem(T, Ks)
        log_pi, log_A, ll = (x.astype(jnp.float32) for x in (log_pi, log_A, ll))
        a = messages.forward_backward(log_pi, log_A, ll)
        b = forward_backward_blocked(log_pi, log_A, ll, block_size=512)
        np.testing.assert_allclose(float(b.log_z), float(a.log_z), rtol=3e-6)
        np.testing.assert_allclose(np.array(b.gamma), np.array(a.gamma), atol=3e-4)

class TestTimeShardedFB:
    @pytest.mark.parametrize("n_dev,T,K", [(8, 64, 5), (4, 100, 3), (2, 10, 4), (1, 16, 3)])
    def test_matches_scan(self, n_dev, T, K, enable_x64):
        mesh = make_mesh(n_dev, axis="time")
        log_pi, log_A, ll = problem(T, K)
        a = messages.forward_backward(log_pi, log_A, ll)
        b = jax.jit(
            lambda p, A, l: time_sharded_forward_backward(p, A, l, mesh)
        )(log_pi, log_A, ll)
        # f64 but NOT bit-exact: the sharded path sums per-shard partial
        # log-normalizers / stats in a different reduction order than the
        # sequential scan, so ~1e-12-relative jitter is inherent; tolerances
        # sit >=100x above the observed error, not at the float boundary
        np.testing.assert_allclose(np.array(b.gamma), np.array(a.gamma), atol=1e-10)
        np.testing.assert_allclose(float(b.log_z), float(a.log_z), rtol=1e-9)
        np.testing.assert_allclose(
            np.array(b.trans_stats), np.array(a.trans_stats), atol=1e-10
        )
        np.testing.assert_allclose(
            np.array(b.init_stats), np.array(a.init_stats), atol=1e-12
        )
        np.testing.assert_allclose(np.array(b.log_c), np.array(a.log_c), atol=1e-10)

    def test_matches_scan_with_weights(self, enable_x64):
        # kept-masks gate init/trans stats across tile boundaries too
        mesh = make_mesh(4, axis="time")
        T, K = 48, 4
        log_pi, log_A, ll = problem(T, K)
        w = jnp.array((rng.uniform(size=T) > 0.3).astype(np.float64))
        a = messages.forward_backward(log_pi, log_A, ll, w)
        b = time_sharded_forward_backward(log_pi, log_A, ll, mesh, weights=w)
        np.testing.assert_allclose(
            np.array(b.trans_stats), np.array(a.trans_stats), atol=1e-10
        )
        np.testing.assert_allclose(
            np.array(b.init_stats), np.array(a.init_stats), atol=1e-12
        )

    def test_long_chain_f32_sharded(self):
        """T=16k chain over 8 virtual devices, f32: exactness at scale."""
        mesh = make_mesh(8, axis="time")
        T, K = 16_000, 8
        log_pi, log_A, ll = problem(T, K)
        log_pi, log_A, ll = (x.astype(jnp.float32) for x in (log_pi, log_A, ll))
        a = messages.forward_backward(log_pi, log_A, ll)
        b = jax.jit(
            lambda p, A, l: time_sharded_forward_backward(p, A, l, mesh)
        )(log_pi, log_A, ll)
        np.testing.assert_allclose(float(b.log_z), float(a.log_z), rtol=3e-6)
        np.testing.assert_allclose(np.array(b.gamma), np.array(a.gamma), atol=3e-4)

    def test_underflow_resistance_sharded(self, enable_x64):
        mesh = make_mesh(4, axis="time")
        T, K = 4096, 4
        log_pi, log_A, ll = problem(T, K)
        ll = ll - 500.0
        a = messages.forward_backward(log_pi, log_A, ll)
        b = time_sharded_forward_backward(log_pi, log_A, ll, mesh)
        assert np.isfinite(float(b.log_z))
        np.testing.assert_allclose(float(b.log_z), float(a.log_z), rtol=1e-9)

    def test_indivisible_raises(self):
        mesh = make_mesh(4, axis="time")
        log_pi, log_A, ll = problem(10, 3)
        with pytest.raises(ValueError):
            time_sharded_forward_backward(log_pi, log_A, ll, mesh)


class TestTimeSharded2D:
    """Batch x time 2-D mesh: data parallelism + exact context parallelism."""

    @pytest.mark.parametrize("db,dt,B,T,K", [(2, 4, 4, 40, 5), (4, 2, 8, 16, 3)])
    def test_matches_batched_scan(self, db, dt, B, T, K, enable_x64):
        from jax.sharding import Mesh
        from pysvihmm_tpu.messages.time_sharded import (
            time_sharded_forward_backward_batched,
        )

        from pysvihmm_tpu.parallel.data_parallel import default_devices

        mesh = Mesh(
            np.array(default_devices()[: db * dt]).reshape(db, dt), ("data", "time")
        )
        log_pi = jnp.array(np.log(rng.dirichlet(np.ones(K))))
        log_A = jnp.array(np.log(rng.dirichlet(np.ones(K), size=K)))
        ll = jnp.array(rng.normal(size=(B, T, K)) * 2.0)
        w = jnp.array((rng.uniform(size=(B, T)) > 0.3).astype(np.float64))
        a = messages.e_step_batched(log_pi, log_A, ll, weights=w, method="scan")
        b = jax.jit(
            lambda p, A, l, wi: time_sharded_forward_backward_batched(
                p, A, l, mesh, weights=wi
            )
        )(log_pi, log_A, ll, w)
        np.testing.assert_allclose(np.array(b.gamma), np.array(a.gamma), atol=1e-10)
        np.testing.assert_allclose(np.array(b.log_z), np.array(a.log_z), rtol=1e-9)
        np.testing.assert_allclose(
            np.array(b.trans_stats), np.array(a.trans_stats), atol=1e-10
        )
        np.testing.assert_allclose(
            np.array(b.init_stats), np.array(a.init_stats), atol=1e-12
        )
        np.testing.assert_allclose(np.array(b.log_c), np.array(a.log_c), atol=1e-10)


class TestStateShardedFB:
    """State-axis (tensor-parallel) sharding for very large K."""

    # NOTE: (1, 9, 4) deliberately avoided — jax/jaxlib 0.9.0's XLA:CPU
    # miscompiles a jitted float64 reverse-scan at exactly T=9, K=4 (the
    # 8-step x 4-wide f64 unroll edge; eager is exact, jit returns garbage).
    # Upstream bug, reproduced minimally; production paths are f32.
    @pytest.mark.parametrize("n_dev,T,K", [(4, 30, 8), (8, 20, 16), (2, 11, 6), (1, 12, 4)])
    def test_matches_scan(self, n_dev, T, K, enable_x64):
        from pysvihmm_tpu.messages.state_sharded import state_sharded_forward_backward

        mesh = make_mesh(n_dev, axis="state")
        log_pi, log_A, ll = problem(T, K)
        w = jnp.array((rng.uniform(size=T) > 0.3).astype(np.float64))
        a = messages.forward_backward(log_pi, log_A, ll, w)
        b = jax.jit(
            lambda p, A, l, wi: state_sharded_forward_backward(p, A, l, mesh, weights=wi)
        )(log_pi, log_A, ll, w)
        np.testing.assert_allclose(np.array(b.gamma), np.array(a.gamma), atol=1e-12)
        np.testing.assert_allclose(float(b.log_z), float(a.log_z), rtol=1e-13)
        np.testing.assert_allclose(
            np.array(b.trans_stats), np.array(a.trans_stats), atol=1e-12
        )
        np.testing.assert_allclose(
            np.array(b.init_stats), np.array(a.init_stats), atol=1e-13
        )
        np.testing.assert_allclose(np.array(b.log_c), np.array(a.log_c), atol=1e-12)

    def test_indivisible_raises(self):
        from pysvihmm_tpu.messages.state_sharded import state_sharded_forward_backward

        mesh = make_mesh(4, axis="state")
        log_pi, log_A, ll = problem(10, 6)  # K=6 not divisible by 4
        with pytest.raises(ValueError):
            state_sharded_forward_backward(log_pi, log_A, ll, mesh)


class TestStateParallelEngine:
    def test_vb_trajectory_matches_single_device(self):
        """fit_large_k over a 4-device state mesh reproduces batch VB on the
        same chain: every state-indexed array K-sharded, zero hand-written
        communication outside the message kernel."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines import batch_vb
        from pysvihmm_tpu.models.hmm import init_params, make_prior
        from pysvihmm_tpu.parallel import fit_large_k

        obs, _, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(3), K=16, D=2, num_seqs=1, T=240, mean_scale=4.0
        )
        prior = make_prior(16, GaussianNIW, obs_dim=2)
        p0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
        ref_p, ref_elbos = batch_vb.fit(
            p0, prior, obs, GaussianNIW, num_iters=12, method="scan"
        )
        mesh = make_mesh(4, axis="state")
        ss_p, ss_elbos = fit_large_k(p0, prior, obs[0], GaussianNIW, mesh, num_iters=12)
        np.testing.assert_allclose(
            np.array(ss_elbos), np.array(ref_elbos), rtol=2e-5
        )
        np.testing.assert_allclose(
            np.array(ss_p.trans), np.array(ref_p.trans), rtol=1e-4
        )
        np.testing.assert_allclose(
            np.array(ss_p.emit.mean), np.array(ref_p.emit.mean), atol=1e-3
        )


class TestTimeShardedEngine:
    def test_vb_trajectory_matches_single_device(self):
        """fit_long_chain over a 4-device time mesh reproduces batch VB on
        the same chain as a (1, T) batch: identical ELBO trajectory and
        identical posterior params (f32 tolerance)."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines import batch_vb
        from pysvihmm_tpu.models.hmm import init_params, make_prior
        from pysvihmm_tpu.parallel import fit_long_chain, make_time_mesh

        obs, _, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(3), K=3, D=2, num_seqs=1, T=400,
            mean_scale=4.0, cov_scale=0.3,
        )
        prior = make_prior(3, GaussianNIW, obs_dim=2)
        p0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
        ref_p, ref_elbos = batch_vb.fit(
            p0, prior, obs, GaussianNIW, num_iters=15, method="scan"
        )
        mesh = make_time_mesh(4)
        ts_p, ts_elbos = fit_long_chain(
            p0, prior, obs[0], GaussianNIW, mesh, num_iters=15
        )
        np.testing.assert_allclose(
            np.array(ts_elbos), np.array(ref_elbos), rtol=2e-5
        )
        np.testing.assert_allclose(
            np.array(ts_p.trans), np.array(ref_p.trans), rtol=1e-3
        )
        np.testing.assert_allclose(
            np.array(ts_p.emit.mean), np.array(ref_p.emit.mean), atol=1e-3
        )

    def test_streamed_vb_matches_single_device(self):
        """Streaming sharded VB (no gamma materialization — the beyond-one-
        chip-HBM tier) reproduces batch VB on the same chain."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines import batch_vb
        from pysvihmm_tpu.models.hmm import init_params, make_prior
        from pysvihmm_tpu.parallel import make_time_mesh, make_ts_stream_vb_step
        from pysvihmm_tpu.parallel.time_parallel import run_vb_scan, shard_chain

        obs, _, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(3), K=3, D=2, num_seqs=1, T=400,
            mean_scale=4.0, cov_scale=0.3,
        )
        prior = make_prior(3, GaussianNIW, obs_dim=2)
        p0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
        ref_p, ref_elbos = batch_vb.fit(
            p0, prior, obs, GaussianNIW, num_iters=12, method="scan"
        )
        mesh = make_time_mesh(4)
        step = make_ts_stream_vb_step(GaussianNIW, mesh, block_size=16)
        chain = shard_chain(obs[0], mesh)
        ts_p, ts_elbos = run_vb_scan(step, p0, prior, chain, 12)
        np.testing.assert_allclose(
            np.array(ts_elbos), np.array(ref_elbos), rtol=2e-5
        )
        np.testing.assert_allclose(
            np.array(ts_p.trans), np.array(ref_p.trans), rtol=1e-3
        )
        np.testing.assert_allclose(
            np.array(ts_p.emit.mean), np.array(ref_p.emit.mean), atol=1e-3
        )

    def test_multinomial_chain(self):
        from pysvihmm_tpu.data.synthetic import gen_multinomial_dataset
        from pysvihmm_tpu.distributions import MultinomialDirichlet
        from pysvihmm_tpu.engines import batch_vb
        from pysvihmm_tpu.models.hmm import init_params, make_prior
        from pysvihmm_tpu.parallel import fit_long_chain, make_time_mesh

        obs, _, _ = gen_multinomial_dataset(
            jax.random.PRNGKey(5), K=3, V=6, num_seqs=1, T=240
        )
        prior = make_prior(3, MultinomialDirichlet, num_symbols=6)
        p0 = init_params(jax.random.PRNGKey(2), prior, MultinomialDirichlet, obs)
        _, ref_elbos = batch_vb.fit(
            p0, prior, obs, MultinomialDirichlet, num_iters=10, method="scan"
        )
        mesh = make_time_mesh(8)
        _, ts_elbos = fit_long_chain(
            p0, prior, obs[0], MultinomialDirichlet, mesh, num_iters=10
        )
        # f32 trajectories accumulated in different reduction orders across
        # 8 shards: observed ~2e-5 relative drift after 10 iters; 1e-4 keeps
        # the margin >=4x off the observed error
        np.testing.assert_allclose(np.array(ts_elbos), np.array(ref_elbos), rtol=1e-4)


class TestBlockedFBEdge:
    def test_extreme_underflow_resistance(self, enable_x64):
        """Per-tile renormalization must survive T=5000 of strongly-peaked
        likelihoods whose raw product underflows any float."""
        T, Ks = 5000, 4
        log_pi, log_A, ll = problem(T, Ks)
        ll = ll - 500.0  # shift: raw lik products underflow immediately
        a = messages.forward_backward(log_pi, log_A, ll)
        b = forward_backward_blocked(log_pi, log_A, ll, block_size=128)
        assert np.isfinite(float(b.log_z))
        np.testing.assert_allclose(float(b.log_z), float(a.log_z), rtol=1e-12)


class TestShardedStream:
    """Time-sharded STREAMING long-chain stats (the multi-chip route to the
    paper's T≈250M regime): per-device two-phase sweeps seeded by one tiny
    boundary all_gather must reproduce the single-device scan's reduced
    stats exactly."""

    @pytest.mark.parametrize("n_dev,T", [(4, 64), (8, 128), (2, 30), (4, 100)])
    def test_matches_scan(self, n_dev, T, enable_x64):
        from pysvihmm_tpu.messages.time_sharded import time_sharded_long_chain_stats

        mesh = make_mesh(n_dev, axis="time")
        K = 5
        log_pi, log_A, ll = problem(T, K)
        xs = jnp.array(rng.normal(size=(T, 3)))
        sf = lambda g, y: (g.T @ y, jnp.sum(g, axis=0))
        si = (jnp.zeros((K, 3)), jnp.zeros((K,)))

        a = messages.forward_backward(log_pi, log_A, ll)
        ref_acc0 = a.gamma.T @ xs
        ref_acc1 = jnp.sum(a.gamma, axis=0)

        got = jax.jit(
            lambda p, A, l, x: time_sharded_long_chain_stats(
                p, A, l, mesh, block_size=8, stat_xs=x, stat_fn=sf, stat_init=si
            )
        )(log_pi, log_A, ll, xs)
        np.testing.assert_allclose(float(got.log_z), float(a.log_z), rtol=1e-9)
        np.testing.assert_allclose(
            np.array(got.init_stats), np.array(a.init_stats), atol=1e-11
        )
        np.testing.assert_allclose(
            np.array(got.trans_stats), np.array(a.trans_stats), atol=1e-9
        )
        np.testing.assert_allclose(np.array(got.acc[0]), np.array(ref_acc0), atol=1e-9)
        np.testing.assert_allclose(np.array(got.acc[1]), np.array(ref_acc1), atol=1e-9)

    def test_nonzero_stat_init_counted_once(self, enable_x64):
        """A nonzero stat_init must enter the psum-reduced accumulator
        exactly ONCE, not once per time-axis device (the seed
        was replicated to every device's sweep and psum-counted D times)."""
        from pysvihmm_tpu.messages.time_sharded import time_sharded_long_chain_stats

        n_dev, T, K = 4, 64, 5
        mesh = make_mesh(n_dev, axis="time")
        log_pi, log_A, ll = problem(T, K)
        xs = jnp.array(rng.normal(size=(T, 3)))
        sf = lambda g, y: (g.T @ y, jnp.sum(g, axis=0))
        si = (jnp.full((K, 3), 7.0), jnp.full((K,), 3.0))

        a = messages.forward_backward(log_pi, log_A, ll)
        got = jax.jit(
            lambda p, A, l, x: time_sharded_long_chain_stats(
                p, A, l, mesh, block_size=8, stat_xs=x, stat_fn=sf, stat_init=si
            )
        )(log_pi, log_A, ll, xs)
        np.testing.assert_allclose(
            np.array(got.acc[0]), np.array(a.gamma.T @ xs + si[0]), atol=1e-9
        )
        np.testing.assert_allclose(
            np.array(got.acc[1]),
            np.array(jnp.sum(a.gamma, axis=0) + si[1]),
            atol=1e-9,
        )

    @pytest.mark.parametrize("n_dev,T", [(4, 64), (8, 128), (4, 100)])
    def test_fused_matches_scan(self, n_dev, T, enable_x64):
        """The likelihood-FUSED sharded tier (per-device fused two-phase
        sweeps from raw observations) reproduces the single-device scan's
        reduced stats and the argmax-gamma decode exactly."""
        from pysvihmm_tpu.messages.time_sharded import time_sharded_fused_stats

        mesh = make_mesh(n_dev, axis="time")
        K, D = 5, 3
        log_pi, log_A, _ = problem(T, K)
        W = jnp.array(rng.normal(size=(D, K)))
        obs = jnp.array(rng.normal(size=(T, D)))
        ell_fn = lambda y: y @ W
        ll = ell_fn(obs)
        sf = lambda g, y: (g.T @ y, jnp.sum(g, axis=0))
        si = (jnp.zeros((K, D)), jnp.zeros((K,)))

        a = messages.forward_backward(log_pi, log_A, ll)
        got = jax.jit(
            lambda p, A, o: time_sharded_fused_stats(
                p, A, o, ell_fn, mesh, block_size=8, chunks=2,
                stat_fn=sf, stat_init=si, emit_argmax=True,
            )
        )(log_pi, log_A, obs)
        np.testing.assert_allclose(float(got.log_z), float(a.log_z), rtol=1e-9)
        np.testing.assert_allclose(
            np.array(got.init_stats), np.array(a.init_stats), atol=1e-11
        )
        np.testing.assert_allclose(
            np.array(got.trans_stats), np.array(a.trans_stats), atol=1e-9
        )
        np.testing.assert_allclose(
            np.array(got.acc[0]), np.array(a.gamma.T @ obs), atol=1e-9
        )
        np.testing.assert_allclose(
            np.array(got.acc[1]), np.array(jnp.sum(a.gamma, axis=0)), atol=1e-9
        )
        z_ref = np.argmax(np.array(a.gamma), axis=-1)
        assert got.z.shape == (T,)
        assert (np.array(got.z) == z_ref).all()

    def test_fused_time_minor_matches_time_major(self, enable_x64):
        """The sharded fused tier with a feature-major (D, T) chain
        reproduces the time-major run exactly,
        including the sharded decode."""
        from pysvihmm_tpu.messages.time_sharded import time_sharded_fused_stats

        n_dev, T, K, D = 4, 96, 5, 3
        mesh = make_mesh(n_dev, axis="time")
        log_pi, log_A, _ = problem(T, K)
        W = jnp.array(rng.normal(size=(D, K)))
        obs = jnp.array(rng.normal(size=(T, D)))
        ell_fn = lambda y: y @ W
        sf = lambda g, y: (g.T @ y, jnp.sum(g, axis=0))
        si = (jnp.zeros((K, D)), jnp.zeros((K,)))

        def run(o, tmin):
            return jax.jit(
                lambda p, A, c: time_sharded_fused_stats(
                    p, A, c, ell_fn, mesh, block_size=8, chunks=2,
                    stat_fn=sf, stat_init=si, emit_argmax=True,
                    time_minor=tmin,
                )
            )(log_pi, log_A, o)

        ref = run(obs, False)
        got = run(obs.T, True)
        np.testing.assert_allclose(float(got.log_z), float(ref.log_z), rtol=1e-12)
        np.testing.assert_allclose(
            np.array(got.trans_stats), np.array(ref.trans_stats), rtol=1e-10
        )
        for x, y in zip(jax.tree.leaves(got.acc), jax.tree.leaves(ref.acc)):
            np.testing.assert_allclose(np.array(x), np.array(y), rtol=1e-10)
        assert (np.array(got.z) == np.array(ref.z)).all()

    def test_fused_vb_step_and_decode_gaussian(self, enable_x64):
        """Full VB step + sharded decode through the fused sharded tier ==
        the single-device long-chain step / decode."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines import batch_vb
        from pysvihmm_tpu.engines.base import long_chain_decode
        from pysvihmm_tpu.models.hmm import init_params, make_prior
        from pysvihmm_tpu.parallel import (
            make_time_mesh,
            make_ts_stream_vb_step,
            shard_chain,
            time_sharded_decode,
        )

        K, D, T = 4, 2, 96
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, 1, T)
        chain = obs[0].astype(jnp.float64)
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, chain)

        ref_step = batch_vb.make_long_chain_step(GaussianNIW, block_size=16)
        ref_p, ref_elbo = ref_step(params, prior, chain)

        mesh = make_time_mesh(4)
        sh = shard_chain(chain, mesh)
        ts_step = make_ts_stream_vb_step(GaussianNIW, mesh, block_size=8,
                                         impl="fused")
        ts_p, ts_elbo = ts_step(params, prior, sh)
        np.testing.assert_allclose(float(ts_elbo), float(ref_elbo), rtol=1e-9)
        for x, y in zip(jax.tree.leaves(ts_p), jax.tree.leaves(ref_p)):
            np.testing.assert_allclose(
                np.array(x), np.array(y), rtol=1e-7, atol=1e-9
            )

        z_ref = long_chain_decode(ref_p, GaussianNIW, chain, block_size=16)
        z_sh = time_sharded_decode(ref_p, GaussianNIW, sh, mesh, block_size=8)
        assert (np.array(z_sh) == np.array(z_ref)).all()

    def test_fused_sharded_T1M_f32(self):
        """The sharded streaming tier at NON-TOY scale —
        T=1M on the 8-device virtual mesh, f32, one full VB step, parity
        with the single-device fused tier to f32 tolerance."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines import batch_vb
        from pysvihmm_tpu.models.hmm import init_params, make_prior
        from pysvihmm_tpu.parallel import (
            make_time_mesh,
            make_ts_stream_vb_step,
            shard_chain,
        )

        K, D, T = 8, 4, 1_000_000
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(11), K, D, 1, T)
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params = init_params(jax.random.PRNGKey(12), prior, GaussianNIW,
                             chain[:10000])

        ref_step = batch_vb.make_long_chain_step(GaussianNIW, block_size=512)
        ref_p, ref_elbo = ref_step(params, prior, chain)

        mesh = make_time_mesh(8)
        sh = shard_chain(chain, mesh)
        ts_step = make_ts_stream_vb_step(GaussianNIW, mesh, block_size=512,
                                         impl="fused")
        ts_p, ts_elbo = ts_step(params, prior, sh)
        np.testing.assert_allclose(float(ts_elbo), float(ref_elbo), rtol=2e-5)
        for x, y in zip(jax.tree.leaves(ts_p), jax.tree.leaves(ref_p)):
            x, y = np.array(x, np.float64), np.array(y, np.float64)
            scale = np.abs(y).max() + 1e-12
            assert np.abs(x - y).max() / scale < 2e-4

    def test_gaussian_estep_parity(self, enable_x64):
        """Full emission E-step through the sharded streaming path equals
        batch_local_step on the same chain."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines.base import batch_local_step
        from pysvihmm_tpu.messages.time_sharded import time_sharded_long_chain_stats
        from pysvihmm_tpu.models.hmm import (
            emission_flat_stats,
            expected_log_params,
            init_params,
            make_prior,
        )

        K, D, T = 4, 2, 96
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, 1, T)
        chain = obs[0].astype(jnp.float64)
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, chain)
        ref, _ = batch_local_step(
            params, GaussianNIW, chain[None], method="scan", need_gamma=False
        )
        mesh = make_mesh(4, axis="time")
        log_pi, log_A = expected_log_params(params)
        ll = GaussianNIW.expected_log_likelihood(params.emit, chain)
        got = time_sharded_long_chain_stats(
            log_pi, log_A, ll, mesh, block_size=8,
            stat_xs=chain,
            stat_fn=lambda g, y: emission_flat_stats(GaussianNIW, params.emit, g, y),
            stat_init=GaussianNIW.zero_stats(params.emit),
        )
        np.testing.assert_allclose(float(got.log_z), float(ref.log_z), rtol=1e-9)
        np.testing.assert_allclose(
            np.array(got.init_stats), np.array(ref.init), atol=1e-10
        )
        np.testing.assert_allclose(
            np.array(got.trans_stats), np.array(ref.trans), rtol=1e-7, atol=1e-9
        )
        for x, y in zip(jax.tree.leaves(got.acc), jax.tree.leaves(ref.emit)):
            np.testing.assert_allclose(np.array(x), np.array(y), rtol=1e-7, atol=1e-9)


class TestBlockedStream:
    """Streaming blocked FB (no M_all / gamma materialization) must produce
    the same reduced stats as the scan E-step for every family and padding
    case — it is the exact long-chain (T = millions) production path."""

    def _check(self, emission, chain, K, S, tol, impl="twophase", **prior_kw):
        from pysvihmm_tpu.engines.base import batch_local_step, long_chain_local_stats
        from pysvihmm_tpu.models.hmm import init_params, make_prior

        prior = make_prior(K, emission, **prior_kw)
        params = init_params(jax.random.PRNGKey(3), prior, emission, chain)
        ref, _ = batch_local_step(
            params, emission, chain[None], method="scan", need_gamma=False
        )
        got = jax.jit(
            lambda p, c: long_chain_local_stats(
                p, emission, c, block_size=S, impl=impl
            )
        )(params, chain)
        np.testing.assert_allclose(float(got.log_z), float(ref.log_z), rtol=tol)
        np.testing.assert_allclose(
            np.array(got.init), np.array(ref.init), atol=10 * tol
        )
        np.testing.assert_allclose(
            np.array(got.trans), np.array(ref.trans), rtol=50 * tol, atol=50 * tol
        )
        for a, b in zip(jax.tree.leaves(got.emit), jax.tree.leaves(ref.emit)):
            np.testing.assert_allclose(
                np.array(a), np.array(b), rtol=50 * tol, atol=50 * tol
            )

    @pytest.mark.parametrize("impl", ["twophase", "assoc", "fused"])
    @pytest.mark.parametrize("T,S", [(210, 64), (129, 64), (65, 64), (2, 8), (40, 8)])
    def test_gaussian_matches_scan(self, T, S, impl, enable_x64):
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW

        K, D = 5, 3
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, 1, T)
        chain = obs[0].astype(jnp.float64)
        self._check(GaussianNIW, chain, K, S, tol=1e-9, impl=impl, obs_dim=D)

    @pytest.mark.parametrize("impl", ["twophase", "assoc", "fused"])
    def test_multinomial_matches_scan(self, impl, enable_x64):
        from pysvihmm_tpu.data.synthetic import gen_multinomial_dataset
        from pysvihmm_tpu.distributions import MultinomialDirichlet

        K, V, T = 4, 11, 137
        obs, _, _ = gen_multinomial_dataset(jax.random.PRNGKey(1), K, V, 1, T)
        self._check(MultinomialDirichlet, obs[0], K, 32, tol=1e-9, impl=impl,
                    num_symbols=V)

    def test_f32_long(self):
        """T=20k f32: stats agree with scan to float tolerance."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW

        K, D, T = 8, 4, 20_000
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(2), K, D, 1, T)
        self._check(GaussianNIW, obs[0], K, 512, tol=2e-4, obs_dim=D)

    def test_fast_state_sampler(self):
        """Vectorized host sampler (scripts-scale generation): empirical
        transitions match A; shapes/edge cases; matched-Hamming helper
        agrees with the reference implementation."""
        from pysvihmm_tpu.data.synthetic import (
            make_gaussian_params,
            sample_states_fast,
        )
        from pysvihmm_tpu.eval.metrics import hamming_error, hamming_error_long

        tp = make_gaussian_params(jax.random.PRNGKey(0), 4, 2, self_prob=0.8)
        A = np.asarray(tp.A)
        z = sample_states_fast(
            np.asarray(tp.pi), A, 400_000, np.random.default_rng(0), block=512
        )
        C = np.zeros((4, 4))
        np.add.at(C, (z[:-1], z[1:]), 1)
        assert np.abs(C / C.sum(1, keepdims=True) - A).max() < 0.01
        for T in (1, 2, 5, 513):
            zz = sample_states_fast(
                np.asarray(tp.pi), A, T, np.random.default_rng(1), block=8
            )
            assert zz.shape == (T,) and zz.min() >= 0 and zz.max() < 4

        est = np.random.default_rng(2).integers(0, 4, size=5000)
        perm = np.array([2, 0, 3, 1])
        true = perm[est].copy()
        true[:500] = (true[:500] + 1) % 4  # inject 10% mismatch
        ref = hamming_error(est, true, 4)
        got = hamming_error_long(jnp.asarray(est), jnp.asarray(true), 4)
        np.testing.assert_allclose(got, ref, atol=1e-12)

    @pytest.mark.parametrize("K,self_prob", [(4, 0.8), (7, 0.95), (64, 0.8)])
    def test_sticky_state_sampler(self, K, self_prob):
        """The parallel sticky-chain sampler (a modular prefix sum of jump
        offsets): empirical transitions match _sticky_transitions, the
        initial state is uniform, and the chain generator's observations
        follow their states."""
        from pysvihmm_tpu.data.synthetic import (
            _sticky_transitions,
            gen_gaussian_chain,
            sample_sticky_states,
        )

        T = 300_000
        z = np.asarray(sample_sticky_states(jax.random.PRNGKey(K), K, self_prob, T))
        assert z.shape == (T,) and z.dtype == np.int32 and 0 <= z.min() and z.max() < K
        C = np.zeros((K, K))
        np.add.at(C, (z[:-1], z[1:]), 1)
        P = C / C.sum(1, keepdims=True)
        A = np.asarray(_sticky_transitions(K, self_prob))
        assert np.abs(np.diag(P) - self_prob).max() < 0.02
        assert np.abs(P - A).max() < 0.02
        starts = [int(sample_sticky_states(jax.random.PRNGKey(s), K, self_prob, 2)[0])
                  for s in range(200)]
        assert len(set(starts)) > K // 2  # not stuck on one initial state
        y, zc, tp = gen_gaussian_chain(jax.random.PRNGKey(1), K, 3, 1000, cov_scale=0.01)
        mu = np.asarray(tp.theta[0])
        assert y.shape == (1000, 3)
        assert np.abs(np.asarray(y) - mu[np.asarray(zc)]).max() < 1.0

    def test_fused_remat_equals_store(self, enable_x64):
        """The rematerializing backward pass (alpha checkpoints, per-chunk
        recompute) must be bit-for-tolerance the stored-alpha path."""
        from pysvihmm_tpu.messages.stream_fused import (
            forward_backward_fused_twophase,
        )

        T, K, D = 333, 5, 3
        log_pi, log_A, _ = problem(T, K)
        W = jnp.array(rng.normal(size=(D, K)))
        obs = jnp.array(rng.normal(size=(T, D)))
        ell_fn = lambda y: y @ W
        sf = lambda g, y: (g.T @ y, jnp.sum(g, axis=0))
        si = (jnp.zeros((K, D)), jnp.zeros((K,)))

        runs = {}
        for store in (True, False):
            runs[store] = jax.jit(
                lambda p, A, o, store=store: forward_backward_fused_twophase(
                    p, A, o, ell_fn, block_size=32, chunks=4,
                    store_alphas=store, stat_fn=sf, stat_init=si,
                    emit_argmax=True,
                )
            )(log_pi, log_A, obs)
        a, b = runs[True], runs[False]
        np.testing.assert_allclose(float(a.log_z), float(b.log_z), rtol=1e-12)
        np.testing.assert_allclose(
            np.array(a.trans_stats), np.array(b.trans_stats), rtol=1e-10
        )
        for x, y in zip(jax.tree.leaves(a.acc), jax.tree.leaves(b.acc)):
            np.testing.assert_allclose(np.array(x), np.array(y), rtol=1e-10)
        assert (np.array(a.z) == np.array(b.z)).all()

    @pytest.mark.parametrize("store", [True, False])
    def test_time_minor_layout_parity(self, store, enable_x64):
        """The feature-major (D, T) observation layout must reproduce the
        time-major results exactly (stats, log_z, decode)."""
        from pysvihmm_tpu.messages.stream_fused import (
            forward_backward_fused_twophase,
        )

        T, K, D = 333, 5, 3
        log_pi, log_A, _ = problem(T, K)
        W = jnp.array(rng.normal(size=(D, K)))
        obs = jnp.array(rng.normal(size=(T, D)))
        ell_fn = lambda y: y @ W
        sf = lambda g, y: (g.T @ y, jnp.sum(g, axis=0))
        si = (jnp.zeros((K, D)), jnp.zeros((K,)))

        def run(o, tmin):
            return jax.jit(
                lambda p, A, c: forward_backward_fused_twophase(
                    p, A, c, ell_fn, block_size=32, chunks=4,
                    store_alphas=store, stat_fn=sf, stat_init=si,
                    emit_argmax=True, time_minor=tmin,
                )
            )(log_pi, log_A, o)

        ref = run(obs, False)
        got = run(obs.T, True)
        np.testing.assert_allclose(float(got.log_z), float(ref.log_z), rtol=1e-12)
        np.testing.assert_allclose(
            np.array(got.trans_stats), np.array(ref.trans_stats), rtol=1e-10
        )
        for x, y in zip(jax.tree.leaves(got.acc), jax.tree.leaves(ref.acc)):
            np.testing.assert_allclose(np.array(x), np.array(y), rtol=1e-10)
        assert (np.array(got.z) == np.array(ref.z)).all()

    @pytest.mark.parametrize("store", [True, False])
    def test_streaming_decode_matches_argmax_gamma(self, store, enable_x64):
        """long_chain_decode == argmax-gamma of the materializing E-step
        (the reference's decode rule) at small T, both remat modes."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines.base import batch_local_step, long_chain_decode
        from pysvihmm_tpu.models.hmm import init_params, make_prior

        K, D, T = 5, 3, 451
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(7), K, D, 1, T)
        chain = obs[0].astype(jnp.float64)
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params = init_params(jax.random.PRNGKey(8), prior, GaussianNIW, chain)

        _, gamma = batch_local_step(params, GaussianNIW, chain[None], method="scan")
        z_ref = np.argmax(np.array(gamma[0]), axis=-1)
        from pysvihmm_tpu.engines.base import _long_chain_ell_fn
        from pysvihmm_tpu.messages import stream_fused
        from pysvihmm_tpu.models.hmm import expected_log_params

        def run(p, c):
            log_pi, log_A = expected_log_params(p)
            return stream_fused.forward_backward_fused_twophase(
                log_pi, log_A, c, _long_chain_ell_fn(p, GaussianNIW),
                block_size=64, chunks=4, store_alphas=store, emit_argmax=True,
            ).z

        z = jax.jit(run)(params, chain)
        assert z.shape == (T,) and z.dtype == jnp.int32
        assert (np.array(z) == z_ref).all()

        z2 = jax.jit(
            lambda p, c: long_chain_decode(p, GaussianNIW, c, block_size=64)
        )(params, chain)
        assert (np.array(z2) == z_ref).all()

    def test_streaming_decode_multinomial(self, enable_x64):
        """Int-token chains (the chromatin-like regime) decode correctly."""
        from pysvihmm_tpu.data.synthetic import gen_multinomial_dataset
        from pysvihmm_tpu.distributions import MultinomialDirichlet
        from pysvihmm_tpu.engines.base import batch_local_step, long_chain_decode
        from pysvihmm_tpu.models.hmm import init_params, make_prior

        K, V, T = 4, 11, 261
        obs, _, _ = gen_multinomial_dataset(jax.random.PRNGKey(9), K, V, 1, T)
        chain = obs[0]
        prior = make_prior(K, MultinomialDirichlet, num_symbols=V)
        params = init_params(
            jax.random.PRNGKey(10), prior, MultinomialDirichlet, chain
        )
        _, gamma = batch_local_step(
            params, MultinomialDirichlet, chain[None], method="scan"
        )
        z_ref = np.argmax(np.array(gamma[0]), axis=-1)
        z = jax.jit(
            lambda p, c: long_chain_decode(
                p, MultinomialDirichlet, c, block_size=32
            )
        )(params, chain)
        assert (np.array(z) == z_ref).all()

    def test_vb_step_matches_batch_vb(self, enable_x64):
        """One long-chain VB step == one batch-VB step on the same chain."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines import batch_vb
        from pysvihmm_tpu.models.hmm import init_params, make_prior

        K, D, T = 4, 2, 333
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(4), K, D, 1, T)
        chain = obs[0].astype(jnp.float64)
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        p0 = init_params(jax.random.PRNGKey(5), prior, GaussianNIW, chain)

        ref_step = batch_vb.make_step(GaussianNIW, method="scan")
        ref_p, ref_elbo = ref_step(p0, prior, chain[None])
        lc_step = batch_vb.make_long_chain_step(GaussianNIW, block_size=64)
        lc_p, lc_elbo = lc_step(p0, prior, chain)

        np.testing.assert_allclose(float(lc_elbo), float(ref_elbo), rtol=1e-10)
        for a, b in zip(jax.tree.leaves(lc_p), jax.tree.leaves(ref_p)):
            np.testing.assert_allclose(np.array(a), np.array(b), rtol=1e-8, atol=1e-10)
