"""Forward-backward kernel tests (messages/pallas_fb.py) in the Pallas
interpreter on the CPU; the same kernels compile through Triton on a CUDA
device (tests/test_gpu_kernels.py, run by chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysvihmm_tpu import messages
from pysvihmm_tpu.messages.pallas_fb import pallas_forward_backward_batched


rng = np.random.default_rng(21)


def problem(B, T, K):
    return (
        jnp.array(np.log(rng.dirichlet(np.ones(K))), jnp.float32),
        jnp.array(np.log(rng.dirichlet(np.ones(K), size=K)), jnp.float32),
        jnp.array(rng.normal(size=(B, T, K)) * 2, jnp.float32),
    )


class TestPallasFB:
    @pytest.mark.parametrize("B,T,K", [(4, 64, 8), (3, 50, 5), (8, 33, 16)])
    def test_matches_scan(self, B, T, K):
        log_pi, log_A, ll = problem(B, T, K)
        fb = pallas_forward_backward_batched(log_pi, log_A, ll, interpret=True)
        ref = jax.vmap(lambda l: messages.forward_backward(log_pi, log_A, l))(ll)
        np.testing.assert_allclose(np.array(fb.gamma), np.array(ref.gamma), atol=2e-6)
        np.testing.assert_allclose(np.array(fb.log_z), np.array(ref.log_z), rtol=2e-6)
        # pallas returns trans_stats summed over the batch (K, K)
        np.testing.assert_allclose(
            np.array(fb.trans_stats), np.array(ref.trans_stats.sum(0)), atol=2e-5
        )
        np.testing.assert_allclose(
            np.array(fb.init_stats), np.array(ref.init_stats), atol=2e-6
        )
        np.testing.assert_allclose(np.array(fb.log_c), np.array(ref.log_c), atol=2e-5)

    @pytest.mark.parametrize("B,T,K", [(4, 64, 8), (3, 40, 5)])
    def test_weighted_matches_scan(self, B, T, K):
        """SVI buffer masks: gated pairwise stats agree with the weighted
        scan path; gamma/log_z are unaffected by weights."""
        log_pi, log_A, ll = problem(B, T, K)
        w = (rng.random((B, T)) > 0.3).astype(np.float32)
        w[0, 0] = 0.0  # at least one discarded chain start (init gating)
        w[1, 0] = 1.0  # and one kept
        wj = jnp.array(w)
        fb = pallas_forward_backward_batched(
            log_pi, log_A, ll, weights=wj, interpret=True
        )
        ref = jax.vmap(
            lambda l, wi: messages.forward_backward(log_pi, log_A, l, weights=wi)
        )(ll, wj)
        np.testing.assert_allclose(np.array(fb.gamma), np.array(ref.gamma), atol=2e-6)
        np.testing.assert_allclose(
            np.array(fb.trans_stats), np.array(ref.trans_stats.sum(0)), atol=2e-5
        )
        np.testing.assert_allclose(np.array(fb.log_z), np.array(ref.log_z), rtol=2e-6)
        np.testing.assert_allclose(
            np.array(fb.init_stats), np.array(ref.init_stats), atol=2e-6
        )

    def test_engine_batched_dispatch(self):
        """e_step_batched(pallas) == e_step_batched(scan) incl. weights."""
        log_pi, log_A, ll = problem(4, 32, 4)
        w = jnp.array((rng.random((4, 32)) > 0.2).astype(np.float32))
        a = messages.e_step_batched(
            log_pi, log_A, ll, weights=w, method="pallas", interpret=True
        )
        b = messages.e_step_batched(log_pi, log_A, ll, weights=w, method="scan")
        np.testing.assert_allclose(np.array(a.trans_stats), np.array(b.trans_stats), atol=2e-5)
        np.testing.assert_allclose(np.array(a.gamma), np.array(b.gamma), atol=2e-6)

    @pytest.mark.parametrize("tiles", [16, 32, 64])
    def test_tiles_override_matches_scan(self, tiles):
        """Every sequence-block size agrees with the scan path, including
        blocks larger than the batch (all but a few rows padded)."""
        B, T, K = 40, 64, 32
        log_pi, log_A, ll = problem(B, T, K)
        ref = jax.vmap(lambda l: messages.forward_backward(log_pi, log_A, l))(ll)
        fb = pallas_forward_backward_batched(
            log_pi, log_A, ll, interpret=True, block_b=tiles
        )
        np.testing.assert_allclose(np.array(fb.gamma), np.array(ref.gamma), atol=2e-6)
        np.testing.assert_allclose(
            np.array(fb.trans_stats), np.array(ref.trans_stats.sum(0)), atol=2e-5
        )
        np.testing.assert_allclose(np.array(fb.log_z), np.array(ref.log_z), rtol=2e-6)

    @pytest.mark.parametrize(
        "B,K,expect", [(1, 2, (16, 16)), (16, 64, (16, 64)), (17, 5, (32, 16)),
                       (1024, 64, (1024, 64)), (3, 100, (16, 128))]
    )
    def test_padded_shapes(self, B, K, expect):
        """Batch rounded up to whole 16-row blocks, states to a power of
        two of at least 16 (the smallest dot the Triton route takes)."""
        from pysvihmm_tpu.messages.pallas_fb import padded_shapes

        assert padded_shapes(B, K) == expect

    def test_stats_sum_properties(self):
        log_pi, log_A, ll = problem(4, 40, 6)
        fb = pallas_forward_backward_batched(log_pi, log_A, ll, interpret=True)
        # each xi_t sums to 1 => batch-summed trans stats sum to B*(T-1)
        np.testing.assert_allclose(
            np.array(fb.trans_stats.sum()), 4 * 39.0, rtol=1e-5
        )
        np.testing.assert_allclose(
            np.array(fb.gamma.sum(-1)), 1.0, rtol=1e-5
        )

    def test_auto_method_resolution(self, monkeypatch):
        """Engines default to method="auto": the kernel on a CUDA device,
        scan elsewhere (resolved at trace time — messages.resolve_method)."""
        from pysvihmm_tpu.messages import resolve_method

        assert resolve_method("auto") == "scan"  # CPU test harness
        assert resolve_method("pallas") == "pallas"  # explicit passes through
        assert resolve_method("blocked") == "blocked"
        monkeypatch.setattr(messages, "on_cuda", lambda: True)
        assert resolve_method("auto") == "pallas"
        assert resolve_method("scan") == "scan"

    def test_e_step_batched_downgrades_fused(self):
        """The fully-fused route is gone: asking for it by name raises
        instead of silently running something else."""
        log_pi, log_A, ll = problem(4, 16, 4)
        with pytest.raises(ValueError, match="unknown E-step method"):
            messages.e_step_batched(log_pi, log_A, ll, method="fused")

    def test_engine_default_method_end_to_end(self):
        """batch_local_step with its default method agrees with explicit scan."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines.base import batch_local_step
        from pysvihmm_tpu.models.hmm import init_params, make_prior

        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), 3, 2, 4, 30)
        prior = make_prior(3, GaussianNIW, obs_dim=2)
        params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
        auto_stats, auto_gamma = batch_local_step(params, GaussianNIW, obs)
        scan_stats, scan_gamma = batch_local_step(params, GaussianNIW, obs, "scan")
        np.testing.assert_array_equal(np.array(auto_gamma), np.array(scan_gamma))
        np.testing.assert_array_equal(
            np.array(auto_stats.trans), np.array(scan_stats.trans)
        )

    def test_windowed_local_step_pallas_vs_scan(self):
        """The shared windowed local step (svi/metaobs engines) agrees
        between the packed pallas path (interpret on CPU) and scan: masked
        emission stats, pair-gated trans stats, gamma at the kept offsets,
        and per-step log normalizers."""
        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines.base import windowed_local_step
        from pysvihmm_tpu.engines.svi import _gather_windows
        from pysvihmm_tpu.models.hmm import init_params, make_prior

        K, D, T, B, W, L = 4, 2, 64, 6, 16, 10
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, 1, T)
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)

        ws = jax.random.randint(jax.random.PRNGKey(2), (B,), 0, T - W + 1)
        windows = _gather_windows(chain, ws, W)
        offs = jnp.arange(B) % (W - L + 1)
        pos = jnp.arange(W)[None, :]
        maskf = ((pos >= offs[:, None]) & (pos < offs[:, None] + L)).astype(
            jnp.float32
        )

        out_p = windowed_local_step(
            params, GaussianNIW, windows, maskf, offs, "pallas", interpret=True
        )
        out_s = windowed_local_step(params, GaussianNIW, windows, maskf, offs, "scan")
        for a, b in zip(jax.tree.leaves(out_p), jax.tree.leaves(out_s)):
            np.testing.assert_allclose(
                np.array(a), np.array(b), rtol=2e-4, atol=1e-5
            )

class TestPallasAccuracy:
    def test_long_chain_f64_oracle(self):
        """Long-chain accuracy regression vs the float64 oracle.

        The f32 beta' chain drifts by a per-sequence common-mode scalar
        (~1e-2 in gamma row sums at T=600 without in-kernel renormalization);
        the kernel's per-step gamma/d renormalization must hold marginals to
        ~1e-6 and summed pairwise stats well below the scan path's error."""
        from pysvihmm_tpu.oracle import numpy_ref as oracle

        B, T, K = 2, 600, 64
        r = np.random.default_rng(7)
        log_pi = np.log(r.dirichlet(np.ones(K)))
        log_A = np.log(r.dirichlet(np.ones(K), size=K))
        ll = r.normal(scale=3.0, size=(B, T, K))
        gams, xis = [], []
        for b in range(B):
            _, _, gam, xi, _ = oracle.forward_backward(log_pi, log_A, ll[b])
            gams.append(gam)
            xis.append(xi)
        gam64, xi64 = np.stack(gams), np.stack(xis).sum(0)
        fb = pallas_forward_backward_batched(
            jnp.asarray(log_pi, jnp.float32),
            jnp.asarray(log_A, jnp.float32),
            jnp.asarray(ll, jnp.float32),
            interpret=True,
        )
        assert np.abs(np.asarray(fb.gamma, np.float64) - gam64).max() < 1e-5
        np.testing.assert_allclose(np.asarray(fb.gamma).sum(-1), 1.0, atol=1e-5)
        assert np.abs(np.asarray(fb.trans_stats, np.float64) - xi64).max() < 5e-3

    def test_packed_scale_imbalance(self):
        """Lane-packed sequences with wildly different per-step scales.

        Regression for a production NaN caught on-chip: the forward renorm
        used the FULL-ROW sum, so when one of the P packed sequences has
        systematically smaller scaling constants (here ~e^-25 per step vs
        ~1 for its row-mate), its share of the row decays without bound and
        underflows f32 within a few dozen steps — gamma/log_c went NaN in
        real SVI training. Per-sequence per-step renorm keeps each packed
        sequence's alpha at unit scale regardless of its row-mate."""
        B, T, K = 2, 200, 64
        r = np.random.default_rng(3)
        log_pi = jnp.asarray(np.log(r.dirichlet(np.ones(K))), jnp.float32)
        log_A = jnp.asarray(np.log(r.dirichlet(np.ones(K), size=K)), jnp.float32)
        base = r.normal(size=(B, T, K)).astype(np.float32)
        # seq 1: every step's best reachable state sits ~25 nats below the
        # per-step max -> c_t ~ e^-25; the max-shift alone cannot fix this
        # (the shift is per-step, the decay is across steps)
        spread = np.zeros((B, T, K), np.float32)
        spread[1] = np.where(np.arange(K)[None, :] == 0, 0.0, -25.0)
        spread[1, :, 0] -= 25.0 * (np.arange(T) % 2)  # keep state 0 unlikely half the time
        ll = jnp.asarray(base + spread)
        fb = pallas_forward_backward_batched(log_pi, log_A, ll, interpret=True)
        fb_s = messages.e_step_batched(log_pi, log_A, ll, method="scan")
        assert bool(jnp.all(jnp.isfinite(fb.gamma)))
        assert bool(jnp.all(jnp.isfinite(fb.log_c)))
        np.testing.assert_allclose(
            np.asarray(fb.log_z), np.asarray(fb_s.log_z), rtol=1e-5, atol=1e-2
        )
        assert np.abs(np.asarray(fb.gamma - fb_s.gamma)).max() < 1e-4


class TestPallasDiagGaussian:
    """The kernel path is family-generic: verify the engine local steps on
    DiagonalGaussianNIG against scan."""

    def _problem(self, B, T, K, D, seed=0):
        from pysvihmm_tpu.data.synthetic import gen_diag_gaussian_dataset
        from pysvihmm_tpu.distributions import DiagonalGaussianNIG
        from pysvihmm_tpu.models.hmm import init_params, make_prior

        obs, _, _ = gen_diag_gaussian_dataset(jax.random.PRNGKey(seed), K, D, B, T)
        prior = make_prior(K, DiagonalGaussianNIG, obs_dim=D)
        params = init_params(
            jax.random.PRNGKey(seed + 1), prior, DiagonalGaussianNIG, obs
        )
        return params, obs

    @pytest.mark.parametrize("method", ["pallas", "pallas_weighted"])
    def test_local_step_matches_scan(self, method):
        from pysvihmm_tpu.distributions import DiagonalGaussianNIG
        from pysvihmm_tpu.engines.base import batch_local_step

        params, obs = self._problem(4, 32, 4, 3)
        w = None
        if method == "pallas_weighted":
            w = jnp.asarray((rng.random((4, 32)) > 0.3).astype(np.float32))
        sf, gf = batch_local_step(
            params, DiagonalGaussianNIG, obs, "pallas", weights=w, interpret=True
        )
        ss, gs = batch_local_step(params, DiagonalGaussianNIG, obs, "scan", weights=w)
        np.testing.assert_allclose(np.array(gf), np.array(gs), atol=5e-5)
        np.testing.assert_allclose(np.array(sf.init), np.array(ss.init), atol=5e-5)
        np.testing.assert_allclose(np.array(sf.trans), np.array(ss.trans), atol=1e-3)
        np.testing.assert_allclose(float(sf.log_z), float(ss.log_z), rtol=2e-6)
        for a, b in zip(jax.tree.leaves(sf.emit), jax.tree.leaves(ss.emit)):
            np.testing.assert_allclose(np.array(a), np.array(b), rtol=3e-3, atol=2e-3)

    def test_windowed_local_step_matches_scan(self):
        from pysvihmm_tpu.distributions import DiagonalGaussianNIG
        from pysvihmm_tpu.engines.base import windowed_local_step

        params, obs = self._problem(6, 24, 4, 3, seed=7)
        # realistic SVI kept-masks: all-ones with buffer edges off
        maskf = jnp.ones((6, 24), jnp.float32)
        maskf = maskf.at[:, :4].set(0.0).at[:, -4:].set(0.0)
        offs = jnp.full((6,), 4, jnp.int32)
        outs = {}
        for method in ("pallas", "scan"):
            outs[method] = windowed_local_step(
                params, DiagonalGaussianNIG, obs, maskf, offs, method,
                interpret=method == "pallas",
            )
        for a, b in zip(jax.tree.leaves(outs["pallas"]), jax.tree.leaves(outs["scan"])):
            np.testing.assert_allclose(np.array(a), np.array(b), rtol=3e-3, atol=2e-3)
