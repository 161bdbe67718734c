"""Regression guards for the matmul-precision policy (utils/precision.py).

On an H100 an f32 dot at JAX's default precision, and at "high", runs in
TF32: measured 2.8e-4 relative and 3 nats absolute on the likelihood form
against float64. So every dot on the inference path must trace at full f32
(HIGHEST), including the forward-backward kernels' own dots. CPU executes
every precision identically, so these tests pin the policy where it is
visible on any backend: the stablehlo ``precision = [...]`` attributes of
the lowered dots.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest

from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu.distributions import GaussianNIW
from pysvihmm_tpu.engines.base import batch_local_step
from pysvihmm_tpu.models.hmm import init_params, make_prior
from pysvihmm_tpu.utils.precision import f32_matmuls


def _dot_lines(lowered_text):
    return [l for l in lowered_text.splitlines() if "dot_general" in l]


def test_f32_matmuls_forces_highest():
    x = jnp.ones((8, 8))
    txt = jax.jit(f32_matmuls(lambda a: a @ a)).lower(x).as_text()
    (line,) = _dot_lines(txt)
    assert "[HIGHEST, HIGHEST]" in line


def test_f32_matmuls_is_exact_f32_not_tf32():
    """The guard names the full-f32 algorithm, not "high" (TF32 on GPU)."""
    x = jnp.ones((8, 8))
    txt = jax.jit(f32_matmuls(lambda a: a @ a)).lower(x).as_text()
    (line,) = _dot_lines(txt)
    assert "HIGH," not in line and "DEFAULT" not in line


def _problem():
    K, D, B, T = 4, 2, 8, 40
    obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, B, T)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
    return prior, params, obs


def _lower_local_step(method, interpret=False):
    _, params, obs = _problem()
    fn = jax.jit(lambda p, o: batch_local_step(p, GaussianNIW, o, method,
                                               interpret=interpret))
    return fn.lower(params, obs).as_text()


def test_pallas_path_precision_tiers():
    """The kernel path, lowered through the Pallas interpreter so the
    kernel's own dots are visible, runs every dot at HIGHEST: the
    likelihood form, the emission statistics and the chain recursions."""
    txt = _lower_local_step("pallas", interpret=True)
    dots = _dot_lines(txt)
    assert dots and all("[HIGHEST, HIGHEST]" in l for l in dots)


def test_scan_path_has_no_default_precision_dots():
    """The correctness-first scan path runs entirely under the f32 guard:
    a DEFAULT-precision dot appearing here means some matmul escaped it."""
    txt = _lower_local_step("scan")
    dots = _dot_lines(txt)
    assert dots, "expected dots in the lowered scan E-step"
    assert not any("[DEFAULT, DEFAULT]" in l for l in dots)


def _entry(name):
    """(jitted fn, args) for one inference entry point."""
    from pysvihmm_tpu.engines import base

    prior, params, obs = _problem()
    chain = obs[0]
    mask = jnp.ones(obs.shape[:2])
    offs = jnp.zeros(obs.shape[0], jnp.int32)
    fns = {
        "windowed_local_step": lambda p: base.windowed_local_step(
            p, GaussianNIW, obs, mask, offs, "scan"),
        "long_chain_fused": lambda p: base.long_chain_local_stats(
            p, GaussianNIW, chain, block_size=8, impl="fused"),
        "long_chain_twophase": lambda p: base.long_chain_local_stats(
            p, GaussianNIW, chain, block_size=8, impl="twophase"),
        "long_chain_decode": lambda p: base.long_chain_decode(
            p, GaussianNIW, chain, block_size=8, chunks=2),
        "lower_bound": lambda p: base.lower_bound(p, prior, GaussianNIW, obs),
        "predictive_log_likelihood": lambda p: base.predictive_log_likelihood(
            p, GaussianNIW, obs),
    }
    return jax.jit(fns[name]), params


@pytest.mark.parametrize(
    "name",
    ["windowed_local_step", "long_chain_fused", "long_chain_twophase",
     "long_chain_decode", "lower_bound", "predictive_log_likelihood"],
)
def test_no_tf32_dots_on_inference_path(name):
    """No entry point lowers a dot at DEFAULT or HIGH (TF32 on the GPU)."""
    fn, params = _entry(name)
    dots = _dot_lines(fn.lower(params).as_text())
    assert dots, name
    assert not any("[DEFAULT" in l or "[HIGH," in l for l in dots), name


class TestStorageDtypeKnobs:
    """Why no Gaussian statistic is ever stored in bf16."""

    def test_bf16_feats_gaussian_breaks_niw_psd(self, monkeypatch):
        """Mechanistic pin of why features stay f32: a collapsed weak state — gamma mass on near-identical
        observations, the windowed-SVI failure regime — rounds its
        y (x) y second moments with a SYSTEMATIC bf16 bias that the
        mean-product subtraction cannot cancel, so the NIW posterior's psi
        loses positive-definiteness and the NEXT E-step goes non-finite.
        The same stats in f32 keep a healthy PSD margin."""
        import numpy as np

        rng_l = np.random.default_rng(0)
        D = 8
        mu = 8.0 * rng_l.standard_normal(D).astype(np.float32)
        y = jnp.asarray(
            mu + 0.01 * rng_l.standard_normal((64, D)).astype(np.float32)
        )
        g = jnp.full((64, 1), 1.0)
        prior = GaussianNIW.make_prior(1, D)

        def min_eig(feats_dtype, scale):
            f = GaussianNIW.ell_features(y).astype(feats_dtype).astype(
                jnp.float32
            )
            stats = GaussianNIW.unpack_flat_stats(prior, g.T @ f)
            q = GaussianNIW.nat_grad_step(prior, prior, stats, scale, 1.0)
            ev = np.linalg.eigvalsh(np.asarray(q.psi[0], np.float64))
            ell = GaussianNIW.expected_log_likelihood(q, y)
            return float(ev.min()), bool(np.isfinite(np.asarray(ell)).all())

        for scale in (1.0, 100.0):
            e32, ok32 = min_eig(jnp.float32, scale)
            e16, ok16 = min_eig(jnp.bfloat16, scale)
            assert e32 > 0.5 and ok32, (scale, e32)
            assert e16 < 0.0 and not ok16, (scale, e16)
