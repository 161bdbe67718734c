"""Benchmark: batched E-step time at K=64, D=8, T=1000 on one GPU.

Measures the full local E-step — expected emission log-likelihoods +
forward-backward + expected sufficient statistics — batched over B
sequences on one card, and compares its throughput against the NumPy
float64 oracle on this host (the reference stand-in: pysvihmm itself is a
NumPy/Cython single-machine library with no published numbers).

Timing: `iters` E-steps chained inside one jitted `lax.scan`, each with a
1e-30 perturbation of every parameter group so XLA cannot hoist the
likelihoods out of the loop; the host clock runs around
`block_until_ready`; the median of `runs` such runs is reported. Without a
GPU it exits non-zero: no number is ever taken on the CPU.

Usage: python bench.py [method] [batch]
Prints one JSON line with the device (platform, device_kind, count, the
card's name and power limit) beside the numbers.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

K, D, T = 64, 8, 1000


def require_gpu():
    import jax

    d = jax.devices()
    if d[0].platform != "gpu":
        sys.exit(f"bench.py: needs a GPU; JAX found {d[0].platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "count": len(d), "card": card}


def bench_jax(batch=1024, iters=10, runs=5, method="auto", family="gaussian"):
    """Median seconds per E-step over `runs` runs of `iters` chained steps."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from pysvihmm_tpu.data.synthetic import (
        gen_diag_gaussian_dataset,
        gen_gaussian_dataset,
    )
    from pysvihmm_tpu.engines.base import batch_local_step
    from pysvihmm_tpu.models.hmm import init_params, make_prior, resolve_emission

    emission = resolve_emission(family)
    gen = gen_diag_gaussian_dataset if family == "diag_gaussian" else gen_gaussian_dataset
    obs, _, _ = gen(jax.random.PRNGKey(0), K, D, batch, T)
    obs = obs.astype(jnp.float32)
    prior = make_prior(K, emission, obs_dim=D)
    params = init_params(jax.random.PRNGKey(1), prior, emission, obs)

    @jax.jit
    def run_n(params_, obs_):
        def estep_chained(carry, _):
            # the perturbation must reach EVERY parameter group, emission
            # params included, or XLA hoists the loop-invariant likelihoods
            # and the benchmark measures an E-step with free likelihoods
            p_var = jax.tree.map(lambda x: x + carry * 1e-30, params_)
            stats, _ = batch_local_step(p_var, emission, obs_, method, need_gamma=False)
            # consume EVERY stat so no part of the E-step is dead code
            tot = stats.log_z + stats.trans.sum() + stats.init.sum()
            tot = tot + sum(jnp.sum(leaf) for leaf in jax.tree.leaves(stats.emit))
            return tot * 0.0 + carry, tot

        return lax.scan(estep_chained, jnp.zeros(()), None, length=iters)[1][-1]

    jax.block_until_ready(run_n(params, obs))  # compile + warm-up
    secs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(run_n(params, obs))
        secs.append((time.perf_counter() - t0) / iters)
    return statistics.median(secs), secs


def bench_oracle(n_seq=2):
    """float64 oracle seconds per sequence: the C forward-backward
    extension when built (the reference's own fast path is Cython), else
    the pure-NumPy loop."""
    from pysvihmm_tpu.oracle import numpy_ref as oracle

    fb = oracle.forward_backward_fast if oracle.HAVE_C_EXT else oracle.forward_backward
    rng = np.random.default_rng(0)
    log_pi = np.log(rng.dirichlet(np.ones(K)))
    log_A = np.log(rng.dirichlet(np.ones(K), size=K))
    mean = rng.normal(size=(K, D))
    kappa = np.full(K, 2.0)
    nu = np.full(K, D + 2.0)
    psi = np.tile(np.eye(D), (K, 1, 1))
    y = rng.normal(size=(T, D))

    t0 = time.perf_counter()
    for _ in range(n_seq):
        ll = oracle.niw_expected_log_likelihood(mean, kappa, nu, psi, y)
        fb(log_pi, log_A, ll)
    return (time.perf_counter() - t0) / n_seq


def main():
    from pysvihmm_tpu.utils.cache import enable_compile_cache

    device = require_gpu()
    enable_compile_cache()
    method = sys.argv[1] if len(sys.argv) > 1 else "auto"
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    dt, secs = bench_jax(batch=batch, method=method)
    orc_dt = bench_oracle()
    print(json.dumps({
        "metric": "estep_ms_K64_T1k",
        "value": dt * 1e3,
        "unit": "ms",
        "runs_ms": [s * 1e3 for s in secs],
        "batch": batch,
        "method": method,
        "seq_per_s": batch / dt,
        "vs_oracle": batch / dt * orc_dt,
        "device": device,
    }))


if __name__ == "__main__":
    main()
