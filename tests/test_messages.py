"""Forward-backward kernel tests: exact agreement scan vs assoc vs grad vs
NumPy oracle vs brute-force enumeration (SURVEY.md §4 "implication" harness).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysvihmm_tpu import messages
from pysvihmm_tpu.oracle import numpy_ref as oracle


rng = np.random.default_rng(7)


def random_problem(T, K, scale=2.0):
    log_pi = np.log(rng.dirichlet(np.ones(K)))
    log_A = np.log(rng.dirichlet(np.ones(K), size=K))
    log_lik = rng.normal(size=(T, K)) * scale
    return log_pi, log_A, log_lik


@pytest.fixture
def problem():
    return random_problem(T=40, K=5)


class TestAgainstOracle:
    @pytest.mark.parametrize("method", ["scan", "assoc", "grad"])
    def test_matches_numpy_oracle(self, problem, method, enable_x64):
        log_pi, log_A, log_lik = problem
        _, _, gam, xi, lz = oracle.forward_backward(log_pi, log_A, log_lik)
        fb = messages.e_step(
            jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik), method=method
        )
        np.testing.assert_allclose(float(fb.log_z), lz, rtol=1e-10)
        np.testing.assert_allclose(np.array(fb.gamma), gam, atol=1e-10)
        np.testing.assert_allclose(np.array(fb.trans_stats), xi, atol=1e-9)
        np.testing.assert_allclose(np.array(fb.init_stats), gam[0], atol=1e-10)

    def test_log_z_brute_force(self, enable_x64):
        log_pi, log_A, log_lik = random_problem(T=7, K=3)
        lz_bf = oracle.log_z_brute_force(log_pi, log_A, log_lik)
        for method in ["scan", "assoc"]:
            fb = messages.e_step(
                jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik), method=method
            )
            np.testing.assert_allclose(float(fb.log_z), lz_bf, rtol=1e-9)

    def test_float32_accuracy(self, problem):
        """f32 (the device compute dtype) within tolerance of the f64 oracle."""
        log_pi, log_A, log_lik = problem
        _, _, gam, xi, lz = oracle.forward_backward(log_pi, log_A, log_lik)
        for method in ["scan", "assoc"]:
            fb = messages.e_step(
                jnp.array(log_pi, jnp.float32),
                jnp.array(log_A, jnp.float32),
                jnp.array(log_lik, jnp.float32),
                method=method,
            )
            np.testing.assert_allclose(float(fb.log_z), lz, rtol=1e-4)
            np.testing.assert_allclose(np.array(fb.gamma), gam, atol=1e-4)
            np.testing.assert_allclose(np.array(fb.trans_stats), xi, atol=1e-3)


class TestMaskedStats:
    @pytest.mark.parametrize("method", ["scan", "assoc"])
    def test_buffered_subchain_discard(self, method, enable_x64):
        """Weights implement the paper's buffer-discard exactly (§3.2)."""
        log_pi, log_A, log_lik = random_problem(T=40, K=4)
        al, be, _, _, _ = oracle.forward_backward(log_pi, log_A, log_lik)
        A = np.exp(log_A)
        m = log_lik.max(1)
        lik = np.exp(log_lik - m[:, None])
        lo, hi = 10, 30
        w = np.zeros(40)
        w[lo:hi] = 1
        xi_sub = np.zeros((4, 4))
        for t in range(lo, hi - 1):
            x = al[t][:, None] * A * (lik[t + 1] * be[t + 1])[None, :]
            xi_sub += x / x.sum()
        fb = messages.e_step(
            jnp.array(log_pi),
            jnp.array(log_A),
            jnp.array(log_lik),
            weights=jnp.array(w),
            method=method,
        )
        np.testing.assert_allclose(np.array(fb.trans_stats), xi_sub, atol=1e-10)
        # w[0] == 0 -> no init contribution
        np.testing.assert_allclose(np.array(fb.init_stats), 0.0, atol=1e-12)


class TestLengthOne:
    def test_length_one_sequence_all_methods(self, enable_x64):
        """T=1 chains (no transitions) work identically in every method."""
        log_pi, log_A, log_lik = random_problem(T=1, K=4)
        ref = messages.e_step(
            jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik), method="scan"
        )
        expect_gamma = np.exp(log_pi + log_lik[0])
        expect_gamma /= expect_gamma.sum()
        np.testing.assert_allclose(np.array(ref.gamma[0]), expect_gamma, atol=1e-12)
        for method in ("assoc", "blocked"):
            fb = messages.e_step(
                jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik), method=method
            )
            np.testing.assert_allclose(np.array(fb.gamma), np.array(ref.gamma), atol=1e-10)
            np.testing.assert_allclose(float(fb.log_z), float(ref.log_z), rtol=1e-12)
            np.testing.assert_allclose(np.array(fb.trans_stats), 0.0, atol=1e-12)
        lz = messages.log_normalizer_assoc(
            jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik)
        )
        np.testing.assert_allclose(float(lz), float(ref.log_z), rtol=1e-12)


class TestBufferErrorDecay:
    def test_buffer_error_decays_geometrically(self, enable_x64):
        """Foti et al. §3.2: the error of subchain marginals against the
        full-chain marginals decays geometrically in the buffer length b
        (at the chain's mixing rate). This is the property the adaptive
        buffer selection and the whole SVI estimator rest on."""
        T, K, L = 400, 4, 40
        log_pi, log_A, log_lik = random_problem(T, K, scale=1.0)
        full = messages.forward_backward(
            jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik)
        )
        s = 180  # kept window [s, s+L)
        errs = []
        for b in (0, 4, 8, 16):
            lo, hi = s - b, s + L + b
            sub = messages.forward_backward(
                jnp.log(jnp.full(K, 1.0 / K)),  # wrong boundary condition
                jnp.array(log_A),
                jnp.array(log_lik[lo:hi]),
            )
            kept = np.array(sub.gamma)[b : b + L]
            errs.append(np.abs(kept - np.array(full.gamma)[s : s + L]).max())
        # monotone decay, and doubling b should at least square away the
        # error until the f64 floor: check a strong per-increment contraction
        assert errs[1] < 0.5 * errs[0]
        assert errs[2] < 0.5 * errs[1]
        assert errs[3] < max(0.5 * errs[2], 1e-12)


class TestDecodeAndSampling:
    def test_viterbi_brute_force(self, enable_x64):
        from itertools import product

        log_pi, log_A, log_lik = random_problem(T=7, K=3)
        best, bp = -np.inf, None
        for path in product(range(3), repeat=7):
            lp = log_pi[path[0]] + log_lik[0, path[0]]
            for t in range(1, 7):
                lp += log_A[path[t - 1], path[t]] + log_lik[t, path[t]]
            if lp > best:
                best, bp = lp, path
        vit = messages.viterbi(jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik))
        assert tuple(np.array(vit)) == bp

    def test_ffbs_marginals(self, enable_x64):
        """FFBS samples have marginals matching smoothed gamma."""
        log_pi, log_A, log_lik = random_problem(T=10, K=3, scale=1.0)
        fb = messages.e_step(jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik))
        n = 4000
        keys = jax.random.split(jax.random.PRNGKey(0), n)
        zs = jax.vmap(
            lambda k: messages.ffbs_sample(
                k, jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik)
            )
        )(keys)
        emp = np.stack([(np.array(zs) == k).mean(0) for k in range(3)], axis=1)
        np.testing.assert_allclose(emp, np.array(fb.gamma), atol=0.03)

    def test_forward_filter_log_consistent(self, enable_x64):
        log_pi, log_A, log_lik = random_problem(T=30, K=4)
        la, lz = messages.forward_filter_log(
            jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik)
        )
        _, lz_scan = messages.forward(
            jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik)
        )
        np.testing.assert_allclose(float(lz), float(lz_scan), rtol=1e-10)
        # normalized filtered marginals agree with normalized-space alpha
        al, _, _, _, _ = oracle.forward_backward(log_pi, log_A, log_lik)
        filt = np.exp(np.array(la) - np.array(la).max(1, keepdims=True))
        filt /= filt.sum(1, keepdims=True)
        np.testing.assert_allclose(filt, al, atol=1e-9)


class TestBatching:
    def test_vmap_equals_loop(self, enable_x64):
        log_pi, log_A, _ = random_problem(T=1, K=4)
        lls = np.stack([random_problem(T=25, K=4)[2] for _ in range(6)])
        fb = jax.vmap(
            lambda l: messages.e_step(jnp.array(log_pi), jnp.array(log_A), l)
        )(jnp.array(lls))
        for b in range(6):
            fb1 = messages.e_step(
                jnp.array(log_pi), jnp.array(log_A), jnp.array(lls[b])
            )
            np.testing.assert_allclose(np.array(fb.gamma[b]), np.array(fb1.gamma), atol=1e-12)
            np.testing.assert_allclose(float(fb.log_z[b]), float(fb1.log_z), rtol=1e-12)

    def test_log_c_sums_to_log_z(self, enable_x64):
        log_pi, log_A, log_lik = random_problem(T=25, K=4)
        for method in ["scan", "assoc"]:
            fb = messages.e_step(
                jnp.array(log_pi), jnp.array(log_A), jnp.array(log_lik), method=method
            )
            np.testing.assert_allclose(
                float(jnp.sum(fb.log_c)), float(fb.log_z), rtol=1e-9
            )
