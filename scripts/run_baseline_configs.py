"""Run the five BASELINE.json evaluation configs end to end and emit one
JSON line per config.

Each config is scaled by --scale so the whole suite is CI-runnable on CPU
(scale 0.1) yet exercises the full-size regimes on the GPU (scale 1):

  1  Gaussian K=4, 100 seqs x T=200, batch VB            (correctness)
  2  Gaussian K=16, single chain, subchain SVI B=32 L=50 (single-chip SVI)
  3  Multinomial K=32, discrete symbols, SVI + pred-LL   (discrete)
  4  K=64 long single chain, time-tiled exact FB + SVI   (long-context)
  5  many sequences sharded over the device mesh, DP SVI
     + elastic step sizes                                 (multi-device shape)

Usage: python scripts/run_baseline_configs.py [--scale 0.1] [--configs 1,2,5]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def _emit(rec):
    print(json.dumps(rec), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--configs", type=str, default="1,2,3,4,5")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    which = {int(x) for x in args.configs.split(",")}
    s = args.scale

    import jax
    import jax.numpy as jnp

    from pysvihmm_tpu.data.synthetic import (
        gen_gaussian_dataset,
        gen_multinomial_dataset,
    )
    from pysvihmm_tpu.distributions import GaussianNIW, MultinomialDirichlet
    from pysvihmm_tpu.engines import batch_vb, svi
    from pysvihmm_tpu.engines.base import decode, predictive_log_likelihood
    from pysvihmm_tpu.eval.metrics import hamming_error
    from pysvihmm_tpu.models.hmm import init_params, make_prior

    key = jax.random.PRNGKey(args.seed)

    if 1 in which:
        K, D, N, T = 4, 2, max(8, int(100 * s)), max(64, int(200 * s * 4))
        obs, z, _ = gen_gaussian_dataset(key, K, D, N, T, mean_scale=6.0, cov_scale=0.3)
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        p0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
        t0 = time.perf_counter()
        params, elbos = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=50)
        e = np.asarray(elbos)
        mono = bool(np.all(np.diff(e) / np.abs(e[:-1]) > -1e-5))
        err = hamming_error(np.asarray(decode(params, GaussianNIW, obs)), np.asarray(z), K)
        _emit({"config": 1, "engine": "batch_vb", "elbo": float(e[-1]),
               "elbo_monotone": mono, "hamming": err,
               "wall_s": round(time.perf_counter() - t0, 2)})
        assert mono and err < 0.05

    if 2 in which:
        K, D, T = 16, 4, max(2000, int(20000 * s))
        obs, z, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(2), K, D, 1, T, mean_scale=6.0, cov_scale=0.3
        )
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        p0 = init_params(jax.random.PRNGKey(3), prior, GaussianNIW, chain)
        cfg = svi.SVIConfig(batch_size=32, subchain_len=50, buffer=10, tau=10.0, kappa=0.6)
        state = svi.init_state(p0, jax.random.PRNGKey(4))
        t0 = time.perf_counter()
        state, metrics = svi.fit(state, prior, chain, GaussianNIW, cfg,
                                 num_steps=max(200, int(2000 * s)))
        err = hamming_error(
            np.asarray(decode(state.params, GaussianNIW, chain[None])), np.asarray(z), K
        )
        _emit({"config": 2, "engine": "svi",
               "noisy_elbo": float(np.asarray(metrics["noisy_elbo"])[-20:].mean()),
               "hamming": err, "wall_s": round(time.perf_counter() - t0, 2)})
        assert err < 0.15

    if 3 in which:
        K, V, N, T = 32, 48, max(16, int(256 * s)), 300
        obs, z, _ = gen_multinomial_dataset(
            jax.random.PRNGKey(5), K, V, N, T, concentration=0.15
        )
        held = obs[: max(2, N // 8)]
        train = obs[max(2, N // 8):]
        prior = make_prior(K, MultinomialDirichlet, num_symbols=V)
        p0 = init_params(jax.random.PRNGKey(6), prior, MultinomialDirichlet, train)
        cfg = svi.SVIConfig(batch_size=8, tau=5.0, kappa=0.6)
        state = svi.init_state(p0, jax.random.PRNGKey(7))
        t0 = time.perf_counter()
        state, _ = svi.fit_minibatch(state, prior, train, MultinomialDirichlet, cfg,
                                     max(200, int(1500 * s)))
        pl_mean = float(
            predictive_log_likelihood(state.params, MultinomialDirichlet, held)
        ) / held.size
        pl_exact = float(
            predictive_log_likelihood(state.params, MultinomialDirichlet, held, exact=True)
        ) / held.size
        _emit({"config": 3, "engine": "svi_minibatch", "pred_ll_per_obs": pl_mean,
               "pred_ll_exact_per_obs": pl_exact,
               "uniform_baseline": -float(np.log(V)),
               "wall_s": round(time.perf_counter() - t0, 2)})
        assert pl_mean > -float(np.log(V))  # beats the uniform model

    if 4 in which:
        K, D, T = 64, 8, max(10000, int(100_000 * s))
        obs, z, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(8), K, D, 1, T, mean_scale=8.0, cov_scale=0.3
        )
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        p0 = init_params(jax.random.PRNGKey(9), prior, GaussianNIW, chain)
        # exact full-chain E-step via the STREAMING time-tiled path, jitted
        # (eagerly it pays per-op dispatch on ~21k ops)
        from pysvihmm_tpu.engines.base import long_chain_local_stats

        exact_fn = jax.jit(
            lambda p, c: long_chain_local_stats(p, GaussianNIW, c, block_size=256)
        )
        float(exact_fn(p0, chain).log_z)  # compile + run
        t0 = time.perf_counter()
        stats = exact_fn(p0, chain)
        exact_logz = float(stats.log_z)
        wall_exact = time.perf_counter() - t0
        # SVI on the same chain (the algorithmic long-context answer)
        cfg = svi.SVIConfig(batch_size=32, subchain_len=50, buffer=10, tau=10.0, kappa=0.6)
        state = svi.init_state(p0, jax.random.PRNGKey(10))
        state, _ = svi.fit(state, prior, chain, GaussianNIW, cfg,
                           num_steps=max(200, int(2000 * s)))
        err = hamming_error(
            np.asarray(decode(state.params, GaussianNIW, chain[None])), np.asarray(z), K
        )
        _emit({"config": 4, "T": T, "exact_blocked_logz": exact_logz,
               "exact_path": "long_chain_local_stats[jit,steady]",
               "exact_wall_s": round(wall_exact, 4), "svi_hamming": err,
               "wall_s": round(time.perf_counter() - t0, 2)})
        assert np.isfinite(exact_logz)

    if 5 in which:
        from pysvihmm_tpu.parallel import (
            make_dp_minibatch_svi_step,
            make_mesh,
            shard_batch,
        )

        n_dev = len(jax.devices())
        K, D, T = 8, 4, 128
        N = max(4 * n_dev, int(1024 * s))
        N -= N % n_dev
        obs, z, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(11), K, D, N, T, mean_scale=6.0, cov_scale=0.3
        )
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        p0 = init_params(jax.random.PRNGKey(12), prior, GaussianNIW, obs)
        mesh = make_mesh(n_dev)
        cfg = svi.SVIConfig(batch_size=n_dev * 4, tau=5.0, kappa=0.6, adaptive=True)
        step = make_dp_minibatch_svi_step(GaussianNIW, cfg, num_seqs=N, mesh=mesh)
        state = svi.init_state(p0, jax.random.PRNGKey(13), adaptive=True)
        sharded = shard_batch(obs, mesh)
        t0 = time.perf_counter()
        steps = max(500, int(2000 * s))

        # one compiled scan (not an eager dispatch flood — hundreds of queued
        # per-step CPU collectives can starve the 8-thread rendezvous)
        @jax.jit
        def run_steps(state0, data):
            def body(st, _):
                st2, m = step(st, prior, data)
                return st2, m["rho"]

            return jax.lax.scan(body, state0, None, length=steps)

        state, rhos = run_steps(state, sharded)
        jax.block_until_ready(state.params)
        metrics = {"rho": rhos[-1]}
        err = hamming_error(
            np.asarray(decode(state.params, GaussianNIW, obs)), np.asarray(z), K
        )
        _emit({"config": 5, "devices": n_dev, "N": N, "steps": steps,
               "elastic_rho": float(metrics["rho"]), "hamming": err,
               "wall_s": round(time.perf_counter() - t0, 2)})
        assert err < 0.15

    _emit({"event": "all_configs_done", "configs": sorted(which)})


if __name__ == "__main__":
    main()
