"""Env-knob smoke test: the remaining PYSVIHMM_* environment knob that
selects a route (PYSVIHMM_STREAM_IMPL, the long-chain tier) must execute
and agree with the other tiers when chosen through the environment.
"""

import jax
import numpy as np

from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu.distributions import GaussianNIW
from pysvihmm_tpu.engines.base import long_chain_local_stats
from pysvihmm_tpu.models.hmm import init_params, make_prior


def test_stream_impl_env_resolution(monkeypatch):
    """PYSVIHMM_STREAM_IMPL selects the long-chain tier; every value must
    execute and agree (the impl= kwarg parity is covered in
    test_longchain.py — this pins the ENV resolution path)."""
    K, D, T = 6, 3, 300
    obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(7), K, D, 1, T)
    chain = obs[0]
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(8), prior, GaussianNIW, chain)
    out = {}
    for impl in ("fused", "twophase", "assoc"):
        monkeypatch.setenv("PYSVIHMM_STREAM_IMPL", impl)
        out[impl] = long_chain_local_stats(
            params, GaussianNIW, chain, block_size=32
        )
    for impl in ("twophase", "assoc"):
        np.testing.assert_allclose(
            float(out[impl].log_z), float(out["fused"].log_z), rtol=1e-5
        )
