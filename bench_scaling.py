"""Scaling-efficiency protocol: isolate the collective overhead of the
data-parallel SVI step (BASELINE north star: >=80% seq/s efficiency from
1 device to N).

It runs on the devices JAX finds and says which (the first output line).
It measures the one thing that separates N-device from 1-device execution
— the per-step COLLECTIVE cost — by running the SAME per-device work twice
on the same mesh:

  (a) "psum":  the production step — per-shard local E-steps, stats
      psum-reduced over the mesh, replicated natural-gradient update;
  (b) "local": identical shapes and arithmetic, but the psum is replaced by
      a local scale (stats * n_dev) — zero communication.

Both variants suffer identical compute contention, so the per-step delta is
the collective cost alone. The DP stat reduce is the ONLY collective of the
production config-5 path (data_parallel.py module doc: all traffic is the
K*K + K*stats pytree once per step), so

    efficiency_bound = t_local / t_psum

is the fraction of a step available for perfect scaling; 1 - bound is the
collective fraction. On virtual CPU devices (a rehearsal, not a device
measurement) the thread rendezvous overestimates it, and throughput is
core contention, so meshes larger than the physical core count are
flagged "oversubscribed".

The 2-D (data x time) composition is measured as context: the same global
work on a pure-DP (N, 1) mesh vs a (N/2, 2) data x time mesh (exact
long-chain FB adds its boundary all_gather/ppermute collectives plus the
three-phase schedule's extra math; its overhead is algorithmic, not just
communication, so it is reported as a composition ratio, not a bound).

Run:  python bench_scaling.py      # on the GPUs of this machine
      JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          python bench_scaling.py      # rehearsal on virtual CPU devices
Emits a device line, one JSON line per measurement and a summary line.
"""

from __future__ import annotations

import json
import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

# Fixed per-device work: B_LOCAL sequences of T steps, K states, D dims,
# with a CONSTANT psum payload (~2 KB of stats) whatever the device count.
B_LOCAL, T, K, D = 64, 500, 16, 4
ITERS = 20


def _problem(n_seqs):
    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.models.hmm import init_params, make_prior

    obs, _, _ = gen_gaussian_dataset(
        jax.random.PRNGKey(0), K, D, n_seqs, T, mean_scale=6.0, cov_scale=0.3
    )
    obs = obs.astype(jnp.float32)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
    return GaussianNIW, obs, prior, params


def _timed(run, params, obs, reps=3):
    z = jnp.zeros(())
    np.asarray(jax.device_get(run(params, obs, z)))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(jax.device_get(run(params, obs, z)))
        best = min(best, (time.perf_counter() - t0) / ITERS)
    return best


def dp_step_time(n_dev, with_psum):
    """Steady per-step time of the DP-SVI-shaped step on an n_dev mesh,
    with the stat reduce either a real psum or a zero-communication scale."""
    from pysvihmm_tpu.distributions import dirichlet
    from pysvihmm_tpu.engines.base import batch_local_step
    from pysvihmm_tpu.models.hmm import HMMParams
    from pysvihmm_tpu.parallel.data_parallel import make_mesh, shard_batch

    emission, obs, prior, params = _problem(B_LOCAL * n_dev)
    mesh = make_mesh(n_dev)
    obs = shard_batch(obs, mesh)

    def local(p, o):
        stats, _ = batch_local_step(p, emission, o, need_gamma=False)
        if with_psum:
            return jax.tree.map(partial(lax.psum, axis_name="data"), stats)
        return jax.tree.map(lambda x: x * n_dev, stats)

    sharded = jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P("data")), out_specs=P(), check_vma=False
    )

    @jax.jit
    def run(params_, obs_, z):
        def body(c, _):
            p_var = jax.tree.map(lambda x: x + c * 1e-30, params_)
            stats = sharded(p_var, obs_)
            # replicated conjugate update (the production global step shape)
            new_p = HMMParams(
                init=dirichlet.posterior(prior.init, stats.init),
                trans=dirichlet.posterior(prior.trans, stats.trans),
                emit=emission.posterior(prior.emit, stats.emit),
            )
            tot = stats.log_z + sum(jnp.sum(x) for x in jax.tree.leaves(new_p))
            return tot * 0.0 + c, tot

        _, tots = lax.scan(body, z, None, length=ITERS)
        return tots[-1]

    return _timed(run, params, obs)


def mesh2d_step_time(db, dt, n_chains, t_len):
    """Per-step time of the exact 2-D (data x time) batched FB on the same
    global work, for the composition-ratio context measurement."""
    from pysvihmm_tpu.messages.time_sharded import (
        time_sharded_forward_backward_batched,
    )
    from pysvihmm_tpu.models.hmm import expected_log_params
    from pysvihmm_tpu.parallel.data_parallel import default_devices

    emission, obs, prior, params = _problem(n_chains)
    obs = obs[:, :1, :].repeat(t_len, axis=1) if obs.shape[1] < t_len else obs[:, :t_len]
    mesh = Mesh(np.array(default_devices()[: db * dt]).reshape(db, dt), ("data", "time"))
    log_pi, log_A = expected_log_params(params)
    ll = emission.expected_log_likelihood(params.emit, obs)  # (B, T, K)

    @jax.jit
    def run(ll_, z):
        def body(c, _):
            r = time_sharded_forward_backward_batched(log_pi, log_A, ll_ + c * 1e-30, mesh)
            tot = jnp.sum(r.log_z) + jnp.sum(r.trans_stats)
            return tot * 0.0 + c, tot

        _, tots = lax.scan(body, z, None, length=ITERS)
        return tots[-1]

    z = jnp.zeros(())
    np.asarray(jax.device_get(run(ll, z)))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(jax.device_get(run(ll, z)))
        best = min(best, (time.perf_counter() - t0) / ITERS)
    return best


def psum_microbench(n_dev):
    """Per-psum cost of the EXACT stats pytree alone (no E-step): the
    constant-payload collective the production step pays once per step."""
    from pysvihmm_tpu.engines.base import LocalStats

    mesh_devices = jax.devices()[:n_dev]
    mesh = Mesh(np.array(mesh_devices), ("data",))
    F = 1 + D + D * (D + 1) // 2
    stats = LocalStats(
        init=jnp.ones((K,), jnp.float32),
        trans=jnp.ones((K, K), jnp.float32),
        emit=jnp.ones((K, F), jnp.float32),
        log_z=jnp.ones((), jnp.float32),
    )

    def local(s):
        def body(c, _):
            r = jax.tree.map(
                partial(lax.psum, axis_name="data"),
                jax.tree.map(lambda x: x + c * 1e-30, s),
            )
            tot = sum(jnp.sum(x) for x in jax.tree.leaves(r))
            return tot * 0.0 + c, tot

        _, tots = lax.scan(body, jnp.zeros(()), None, length=ITERS)
        return tots[-1]

    run = jax.jit(
        jax.shard_map(local, mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False)
    )
    np.asarray(jax.device_get(run(stats)))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(jax.device_get(run(stats)))
        best = min(best, (time.perf_counter() - t0) / ITERS)
    return best


def ts_stream_step_time(n_dev, t_len):
    """Per-step time of the likelihood-FUSED sharded streaming E-step
    (time_sharded_fused_stats via time_sharded_stream_stats) on an n_dev
    time mesh at fixed global T — the strong-scaling composition
    measurement for the multi-device long-chain route."""
    import jax.numpy as jnp

    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.parallel import (
        make_time_mesh,
        shard_chain,
        time_sharded_stream_stats,
    )

    K_, D_ = 8, 4
    obs, _, _ = gen_gaussian_dataset(
        jax.random.PRNGKey(0), K_, D_, 1, t_len, mean_scale=6.0
    )
    chain = obs[0]
    prior = make_prior(K_, GaussianNIW, obs_dim=D_)
    params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW,
                         chain[:10_000])
    mesh = make_time_mesh(n_dev, devices=jax.devices()[:n_dev])
    sh = shard_chain(chain, mesh)

    @jax.jit
    def run(p, c, z):
        def body(carry, _):
            s = time_sharded_stream_stats(
                p, GaussianNIW, c + (carry * 1e-30), mesh,
                block_size=512, impl="fused",
            )
            return carry + s.log_z * 1e-30, s.log_z

        _, zs = jax.lax.scan(body, z, None, length=ITERS)
        return zs

    np.asarray(jax.device_get(run(params, sh, jnp.float32(0.0))))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(jax.device_get(run(params, sh, jnp.float32(0.0))))
        best = min(best, (time.perf_counter() - t0) / ITERS)
    return best


def main():
    devices = jax.devices()
    n_max = len(devices)
    print(json.dumps({"platform": devices[0].platform,
                      "device_kind": devices[0].device_kind, "count": n_max}),
          flush=True)
    # virtual CPU devices beyond the physical cores serialize at every psum
    phys = (os.cpu_count() or 1) if devices[0].platform == "cpu" else n_max
    out = []
    for n in (2, 4, 8):
        if n > n_max:
            continue
        t_psum = dp_step_time(n, with_psum=True)
        t_local = dp_step_time(n, with_psum=False)
        t_coll = psum_microbench(n)
        rec = {
            "bench": "dp_collective_isolation",
            "n_dev": n,
            "oversubscribed": n > phys,
            "per_dev_seqs": B_LOCAL,
            "t_psum_ms": round(t_psum * 1e3, 3),
            "t_local_ms": round(t_local * 1e3, 3),
            "t_psum_alone_ms": round(t_coll * 1e3, 3),
            "collective_frac": round(max(0.0, 1 - t_local / t_psum), 4),
            "efficiency_bound": round(min(1.0, t_local / t_psum), 4),
        }
        print(json.dumps(rec), flush=True)
        out.append(rec)

    # 2-D composition context: same global work, (8, 1) vs (4, 2)
    if n_max >= 8:
        t_dp = mesh2d_step_time(8, 1, n_chains=32, t_len=T)
        t_2d = mesh2d_step_time(4, 2, n_chains=32, t_len=T)
        rec = {
            "bench": "mesh2d_composition",
            "global_work": {"B": 32, "T": T, "K": K},
            "t_mesh_8x1_ms": round(t_dp * 1e3, 3),
            "t_mesh_4x2_ms": round(t_2d * 1e3, 3),
            "composition_ratio": round(t_2d / t_dp, 3),
        }
        print(json.dumps(rec), flush=True)
        out.append(rec)

    # fused sharded streaming tier: strong scaling at fixed global T —
    # the composition measurement for the multi-device long-chain route
    TS_T = 262_144
    ts_times = {}
    for n in (1, 2, 4):
        if n > n_max or n > phys:
            continue
        ts_times[n] = ts_stream_step_time(n, TS_T)
    if 1 in ts_times and len(ts_times) > 1:
        rec = {
            "bench": "ts_stream_fused_strong_scaling",
            "T": TS_T, "K": 8, "D": 4,
            "t_ms_by_ndev": {str(n): round(t * 1e3, 2)
                             for n, t in ts_times.items()},
            "efficiency_by_ndev": {
                str(n): round(ts_times[1] / (n * ts_times[n]), 3)
                for n in ts_times if n > 1
            },
            "note": "partial wall speedup is EXPECTED: the per-device "
                    "phase-3 sequential depth is block_size-fixed (only "
                    "the per-step row count shrinks with devices). The "
                    "tier's primary scaling axis is MEMORY capacity — T "
                    "beyond one device's memory — with the speedup as bonus.",
        }
        print(json.dumps(rec), flush=True)
        out.append(rec)

    # the defensible bound comes from meshes that fit the physical cores:
    # oversubscribed virtual devices serialize at every psum barrier, which
    # measures thread scheduling, not communication
    bounds = [
        r["efficiency_bound"]
        for r in out
        if "efficiency_bound" in r and not r["oversubscribed"]
    ]
    print(json.dumps({
        "summary": "scaling_efficiency_bound",
        "min_efficiency_bound_physical": min(bounds) if bounds else None,
        "north_star": ">=0.80",
        "pass": bool(bounds and min(bounds) >= 0.80),
        "platform": devices[0].platform,
        "note": "bound from non-oversubscribed meshes; the psum payload is "
                "~2 KB and constant in device count",
    }), flush=True)


if __name__ == "__main__":
    main()
