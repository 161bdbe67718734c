"""Secondary BASELINE metric: ELBO-convergence wall-clock vs the
reference-equivalent NumPy float64 oracle (`oracle/numpy_ref.BatchVBOracle`,
the stand-in for pysvihmm's `hmmbatchcd.VBHMM.infer` — the reference itself
is unrunnable here; SURVEY.md provenance note).

Both engines are started from IDENTICAL variational initializations and run
the same coordinate ascent, so their per-iteration ELBO trajectories agree
to f32 tolerance (tests/test_batch_vb.py asserts this exactly); convergence
wall-clock therefore reduces to per-iteration wall-clock at matched config.
This script measures both and emits one JSON line:

  {"metric": "batchvb_iter_wallclock_speedup_vs_reference",
   "value": <oracle_iter_s / jax_iter_s>, ...}

Usage: python scripts/bench_convergence.py [--num-seqs 100] [--T 200]
       [--K 4] [--D 2] [--iters 50]
(defaults = BASELINE config 1). Runs on whatever backend JAX selects
(the GPU when there is one; JAX_PLATFORMS=cpu for the host).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-seqs", type=int, default=100)
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--K", type=int, default=4)
    ap.add_argument("--D", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--oracle-iters", type=int, default=10)
    args = ap.parse_args(argv)
    K, D = args.K, args.D

    import jax

    from pysvihmm_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines import batch_vb
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.oracle.numpy_ref import BatchVBOracle

    obs, _, _ = gen_gaussian_dataset(
        jax.random.PRNGKey(0), K, D, args.num_seqs, args.T,
        mean_scale=6.0, cov_scale=0.3,
    )
    obs = obs.astype(jnp.float32)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    p0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)

    # --- ours: jitted coordinate ascent, iterations inside one lax.scan ---
    fit = jax.jit(
        lambda p, o: batch_vb.fit(p, prior, o, GaussianNIW, num_iters=args.iters)
    )
    final, elbos = fit(p0, obs)  # compile + warmup
    np.asarray(jax.device_get(elbos))
    t0 = time.perf_counter()
    final, elbos = fit(p0, obs)
    elbos = np.asarray(jax.device_get(elbos))
    jax_iter_s = (time.perf_counter() - t0) / args.iters

    # --- oracle: same priors, same initial variational params, float64 ---
    orc = BatchVBOracle(
        [np.asarray(o, np.float64) for o in obs],
        K,
        np.asarray(prior.init, np.float64),
        np.asarray(prior.trans, np.float64),
        np.asarray(prior.emit.mean, np.float64),
        np.asarray(prior.emit.kappa, np.float64),
        np.asarray(prior.emit.nu, np.float64),
        np.asarray(prior.emit.psi, np.float64),
    )
    orc.var_init = np.asarray(p0.init, np.float64)
    orc.var_tran = np.asarray(p0.trans, np.float64)
    orc.var_niw = (
        np.asarray(p0.emit.mean, np.float64),
        np.asarray(p0.emit.kappa, np.float64),
        np.asarray(p0.emit.nu, np.float64),
        np.asarray(p0.emit.psi, np.float64),
    )
    t0 = time.perf_counter()
    orc.infer(maxit=args.oracle_iters, tol=0.0)
    orc_iter_s = (time.perf_counter() - t0) / args.oracle_iters

    # same ascent from the same init: trajectories must agree
    n_cmp = min(args.oracle_iters, args.iters)
    traj_rel_err = float(
        np.max(
            np.abs(elbos[:n_cmp] - np.asarray(orc.elbo_history[:n_cmp]))
            / np.abs(np.asarray(orc.elbo_history[:n_cmp]))
        )
    )

    print(
        json.dumps(
            {
                "metric": "batchvb_iter_wallclock_speedup_vs_reference",
                "value": round(orc_iter_s / jax_iter_s, 2),
                "unit": "x",
                "jax_iter_ms": round(jax_iter_s * 1e3, 3),
                "oracle_iter_ms": round(orc_iter_s * 1e3, 2),
                "elbo_final": float(elbos[-1]),
                "trajectory_rel_err_vs_oracle": traj_rel_err,
                "backend": jax.default_backend(),
                "config": {
                    "K": K, "D": D, "num_seqs": args.num_seqs,
                    "T": args.T, "iters": args.iters,
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
