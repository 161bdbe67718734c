"""Likelihood-fused streaming E-step + decode at the paper's flagship scale.

The fused tier (messages/stream_fused.py) computes likelihoods per chunk
from raw observations and rematerializes alpha in the backward pass, so
one card's ceiling is set by the OBSERVATIONS (T·D floats / T int tokens), not the
(T, K) likelihood array — the regime of the reference paper's T≈250M
chromatin experiment (Foti et al. 2014 §4, SURVEY.md:284), which also ends
in a SEGMENTATION: the streaming decode phase emits the full argmax-gamma
state path and scores full-chain Hamming against generator truth.

Phases (one JSON line each):
  exact_fused    — jitted fused streaming E-step: log_z, wall, steps/s
  exact_twophase — optional A/B vs the (T,K)-materializing tier
  subchain_svi   — buffered-subchain SVI fit (the paper's estimator)
  fused_decode   — full-chain streaming decode + FULL-chain Hamming

Usage:
  python scripts/run_fused_scale.py --T 50000000                 # Gaussian
  python scripts/run_fused_scale.py --family multinomial --T 250000000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=["gaussian", "multinomial"],
                    default="gaussian")
    ap.add_argument("--T", type=int, default=50_000_000)
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--obs-dim", type=int, default=8)
    ap.add_argument("--V", type=int, default=32)
    ap.add_argument("--block-size", type=int, default=1024)
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--store-alphas", action="store_true",
                    help="store filtered messages instead of remat")
    ap.add_argument("--compare-twophase", action="store_true")
    ap.add_argument("--svi-steps", type=int, default=300)
    ap.add_argument("--svi-batch", type=int, default=256)
    ap.add_argument("--concentration", type=float, default=0.3,
                    help="multinomial emission Dirichlet concentration "
                    "(lower = sparser symbol distributions = more "
                    "identifiable states; chromatin-like sparse marks "
                    "~0.05)")
    ap.add_argument("--skip-decode", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-cache", type=str, default=None,
                    help="path to an .npz holding (obs, z): written after "
                    "generation if absent, loaded (skipping generation) if "
                    "present — lets the slow host-side generation run under "
                    "JAX_PLATFORMS=cpu while the chip is busy (--gen-only "
                    "exits right after writing)")
    ap.add_argument("--gen-only", action="store_true")
    args = ap.parse_args(argv)

    import jax

    from pysvihmm_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from pysvihmm_tpu.data.synthetic import (
        make_gaussian_params,
        make_multinomial_params,
        sample_states_fast,
    )
    from pysvihmm_tpu.distributions import GaussianNIW, MultinomialDirichlet
    from pysvihmm_tpu.engines import svi
    from pysvihmm_tpu.engines.base import (
        _long_chain_ell_fn,
        long_chain_local_stats,
    )
    from pysvihmm_tpu.eval.metrics import hamming_error_long
    from pysvihmm_tpu.models.hmm import (
        expected_log_params,
        init_params,
        make_prior,
    )

    T, K = args.T, args.K

    # ---- host-side generation (vectorized sampler, ~50x the naive loop)
    t0 = time.perf_counter()
    if args.data_cache and not args.data_cache.endswith(".npz"):
        # np.savez appends ".npz" unconditionally; normalize up front so
        # the cache-hit check and the write agree on one path
        args.data_cache += ".npz"
    cached = args.data_cache and os.path.exists(args.data_cache)
    rng = np.random.default_rng(args.seed + 1)
    if cached:
        data = np.load(args.data_cache, mmap_mode="r")
        obs_np, z = data["obs"], np.asarray(data["z"])
        assert obs_np.shape[0] == T, obs_np.shape
        # true params re-derive from the same key (true_param_decode needs
        # them; the cache holds only the sampled data)
        if args.family == "gaussian":
            D = args.obs_dim
            tp = make_gaussian_params(
                jax.random.PRNGKey(args.seed), K, D,
                mean_scale=8.0, cov_scale=0.3,
            )
            emission = GaussianNIW
            prior = make_prior(K, GaussianNIW, obs_dim=D)
        else:
            D = None
            tp = make_multinomial_params(
                jax.random.PRNGKey(args.seed), K, args.V,
                concentration=args.concentration,
            )
            emission = MultinomialDirichlet
            prior = make_prior(K, MultinomialDirichlet, num_symbols=args.V)
    elif args.family == "gaussian":
        D = args.obs_dim
        tp = make_gaussian_params(
            jax.random.PRNGKey(args.seed), K, D, mean_scale=8.0, cov_scale=0.3
        )
        z = sample_states_fast(np.asarray(tp.pi), np.asarray(tp.A), T, rng)
        mu = np.asarray(tp.theta[0], np.float32)
        sd = float(np.sqrt(np.asarray(tp.theta[1])[0, 0, 0]))
        obs_np = mu[z] + sd * rng.standard_normal((T, D)).astype(np.float32)
        emission = GaussianNIW
        prior = make_prior(K, GaussianNIW, obs_dim=D)
    else:
        D = None
        tp = make_multinomial_params(
            jax.random.PRNGKey(args.seed), K, args.V,
            concentration=args.concentration,
        )
        z = sample_states_fast(np.asarray(tp.pi), np.asarray(tp.A), T, rng)
        phi_cum = np.cumsum(np.asarray(tp.theta, np.float64), axis=1)
        obs_np = np.empty((T,), np.int32)
        u2 = rng.random(T)
        for k in range(K):  # vectorized per state: K passes, no T-loop
            m = z == k
            obs_np[m] = np.searchsorted(phi_cum[k], u2[m], side="right")
        np.clip(obs_np, 0, args.V - 1, out=obs_np)
        emission = MultinomialDirichlet
        prior = make_prior(K, MultinomialDirichlet, num_symbols=args.V)
    if args.data_cache and not cached:
        np.savez(args.data_cache, obs=obs_np, z=z)
    gen_wall = time.perf_counter() - t0
    if args.gen_only:
        print(json.dumps({"phase": "gen_only", "T": T,
                          "gen_wall_s": round(gen_wall, 1),
                          "cache": args.data_cache}), flush=True)
        return

    # Gaussian chains go to the device FEATURE-MAJOR (D, T) (the layout
    # ROADMAP Queue 3 asks to re-measure on the GPU). The SVI phase
    # samples subchains, so it gets a bounded time-major head.
    time_minor = args.family == "gaussian"
    if time_minor:
        chain = jnp.asarray(np.ascontiguousarray(obs_np.T))  # (D, T)
        svi_head = min(T, 10_000_000)
        chain_svi = jnp.asarray(obs_np[:svi_head])
    else:
        chain = jnp.asarray(obs_np)
        chain_svi = chain
    del obs_np
    head = min(T, 100_000)
    p0 = init_params(jax.random.PRNGKey(args.seed + 2), prior, emission,
                     chain_svi[:head])

    base = {"family": args.family, "T": T, "K": K,
            **({"D": D} if D else {"V": args.V}),
            "block_size": args.block_size, "chunks": args.chunks,
            "store_alphas": bool(args.store_alphas)}

    # ---- exact fused streaming E-step
    def fused_stats(p, c):
        from pysvihmm_tpu.messages.stream_fused import (
            forward_backward_fused_twophase,
        )

        log_pi, log_A = expected_log_params(p)
        from pysvihmm_tpu.models.hmm import emission_flat_stats

        return forward_backward_fused_twophase(
            log_pi, log_A, c, _long_chain_ell_fn(p, emission),
            block_size=args.block_size, chunks=args.chunks,
            store_alphas=args.store_alphas or None,
            stat_fn=lambda g, y: emission_flat_stats(emission, p.emit, g, y),
            stat_init=emission.zero_stats(p.emit),
            time_minor=time_minor,
        )

    from pysvihmm_tpu.utils.precision import f32_matmuls

    exact_fn = jax.jit(f32_matmuls(fused_stats))
    float(exact_fn(p0, chain).log_z)  # compile + first run
    t0 = time.perf_counter()
    log_z = float(exact_fn(p0, chain).log_z)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "phase": "exact_fused", **base, "log_z": log_z,
        "wall_s": round(wall, 3), "steps_per_s": round(T / wall, 1),
        "gen_wall_s": round(gen_wall, 1),
    }), flush=True)
    assert np.isfinite(log_z)

    # ---- optional A/B vs the (T, K)-materializing two-phase tier
    if args.compare_twophase and (not time_minor or T <= chain_svi.shape[0]):
        cmp_chain = chain_svi if time_minor else chain
        tp_fn = jax.jit(
            lambda p, c: long_chain_local_stats(
                p, emission, c, block_size=256, impl="twophase"
            )
        )
        float(tp_fn(p0, cmp_chain).log_z)
        t0 = time.perf_counter()
        log_z2 = float(tp_fn(p0, cmp_chain).log_z)
        wall2 = time.perf_counter() - t0
        print(json.dumps({
            "phase": "exact_twophase", **base, "block_size": 256,
            "log_z": log_z2, "wall_s": round(wall2, 3),
            "steps_per_s": round(T / wall2, 1),
            "log_z_rel_diff": abs(log_z2 - log_z) / abs(log_z),
        }), flush=True)

    # ---- the paper's estimator: buffered-subchain SVI fit
    cfg = svi.SVIConfig(batch_size=args.svi_batch, subchain_len=50, buffer=10,
                        tau=10.0, kappa=0.6)
    state = svi.init_state(p0, jax.random.PRNGKey(args.seed + 3))
    t0 = time.perf_counter()
    state, metrics = svi.fit(state, prior, chain_svi, emission, cfg,
                             num_steps=args.svi_steps)
    ne = np.asarray(metrics["noisy_elbo"])
    svi_wall = time.perf_counter() - t0
    print(json.dumps({
        "phase": "subchain_svi", **base, "steps": args.svi_steps,
        "B": cfg.batch_size, "L": cfg.subchain_len, "buffer": cfg.buffer,
        "wall_s": round(svi_wall, 1),
        "noisy_elbo_last20": float(ne[-20:].mean()),
    }), flush=True)

    # ---- full-chain streaming decode + full-chain matched Hamming
    if not args.skip_decode:
        from pysvihmm_tpu.engines.base import long_chain_decode
        from pysvihmm_tpu.models.hmm import HMMParams

        dec_fn = jax.jit(
            lambda p, c: long_chain_decode(
                p, emission, c, block_size=args.block_size,
                chunks=args.chunks, time_minor=time_minor,
            )
        )
        dec_fn(p0, chain).block_until_ready()  # compile at full shape
        t0 = time.perf_counter()
        z_hat = dec_fn(state.params, chain)
        z_hat.block_until_ready()
        dec_wall = time.perf_counter() - t0
        z_dev = jnp.asarray(z)
        ham = hamming_error_long(z_hat, z_dev, K)
        print(json.dumps({
            "phase": "fused_decode", **base,
            "wall_s": round(dec_wall, 3),
            "steps_per_s": round(T / dec_wall, 1),
            "hamming_full_chain": round(ham, 6),
        }), flush=True)

        # decode at the BAYES FLOOR: pseudo-posterior params whose
        # expected parameters equal the generator's truth (Dirichlet/NIW
        # counts at concentration CONC >> 1), so the full-chain error is
        # the model's intrinsic per-step ambiguity — separating decoder
        # exactness from SVI fit quality.
        CONC = 1e8
        if args.family == "multinomial":
            # +1 floors the counts of near-zero phi entries (sparse
            # concentration draws have phi ~ 1e-15, whose raw CONC*phi
            # counts land in digamma's divergent region and wreck
            # E[log phi]); E[log] ~= log(phi + 1/CONC), Bayes-equivalent
            emit_true = CONC * jnp.asarray(tp.theta) + 1.0
        else:
            from pysvihmm_tpu.distributions.niw import NIW

            emit_true = NIW(
                mean=jnp.asarray(tp.theta[0]),
                kappa=jnp.full((K,), CONC),
                nu=jnp.full((K,), CONC),
                psi=CONC * jnp.asarray(tp.theta[1]),
            )
        p_true = HMMParams(
            init=CONC * jnp.asarray(tp.pi),
            trans=CONC * jnp.asarray(tp.A),
            emit=emit_true,
        )
        t0 = time.perf_counter()
        z_star = dec_fn(p_true, chain)
        z_star.block_until_ready()
        floor_wall = time.perf_counter() - t0
        ham_floor = hamming_error_long(z_star, z_dev, K)
        print(json.dumps({
            "phase": "true_param_decode", **base,
            "wall_s": round(floor_wall, 3),
            "steps_per_s": round(T / floor_wall, 1),
            "hamming_bayes_floor": round(ham_floor, 6),
        }), flush=True)


if __name__ == "__main__":
    main()
