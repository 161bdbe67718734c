"""End-to-end smoke: one tiny engine fit per family through the public API.

Part of the <2-min SMOKE TIER (scripts/smoke.sh) — the commit gate that
must be green before ANY snapshot commit. The full tier
(`pytest tests/ -q`) remains the release bar.
"""

import jax
import numpy as np

from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset, gen_multinomial_dataset
from pysvihmm_tpu.distributions import GaussianNIW, MultinomialDirichlet
from pysvihmm_tpu.engines import batch_vb, svi
from pysvihmm_tpu.engines.base import decode
from pysvihmm_tpu.eval.metrics import hamming_error
from pysvihmm_tpu.models.hmm import init_params, make_prior


def test_vb_end_to_end_gaussian():
    obs, z, _ = gen_gaussian_dataset(
        jax.random.PRNGKey(0), K=3, D=2, num_seqs=8, T=120,
        mean_scale=6.0, cov_scale=0.3,
    )
    prior = make_prior(3, GaussianNIW, obs_dim=2)
    p0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
    params, elbos = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=25)
    e = np.asarray(elbos)
    assert np.all(np.diff(e) / np.abs(e[:-1]) > -1e-5), "ELBO not monotone"
    err = hamming_error(np.asarray(decode(params, GaussianNIW, obs)), np.asarray(z), 3)
    assert err < 0.05, f"hamming {err}"


def test_svi_end_to_end_multinomial():
    obs, _, _ = gen_multinomial_dataset(jax.random.PRNGKey(2), K=3, V=8,
                                        num_seqs=1, T=1500)
    prior = make_prior(3, MultinomialDirichlet, num_symbols=8)
    p0 = init_params(jax.random.PRNGKey(3), prior, MultinomialDirichlet)
    cfg = svi.SVIConfig(batch_size=8, subchain_len=40, buffer=8, tau=5.0, kappa=0.6)
    st = svi.init_state(p0, jax.random.PRNGKey(4))
    st, metrics = svi.fit(st, prior, obs[0], MultinomialDirichlet, cfg, num_steps=60)
    ne = np.asarray(metrics["noisy_elbo"])
    assert np.isfinite(ne).all()
    assert ne[-10:].mean() > ne[:10].mean(), "noisy ELBO did not improve"
