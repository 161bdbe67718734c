"""Prove the library's main paths on an NVIDIA GPU.

Runs the public entry points once each at the repository's headline sizes,
on data drawn from --seed through pysvihmm_tpu.data.synthetic, and checks
every result against an independent reference:

  device             a GPU is present (no CPU fallback); the card's name and
                     power limit, and the XLA_FLAGS in force
  gpu_tests          the test cases marked `gpu` (tests/test_gpu_kernels.py),
                     in this process
  estep_gaussian     K=64, D=8, B=1024, T=1000 E-step, method="auto" (the
                     Triton forward-backward kernel) against the scan path on
                     the card and the float64 oracle on 4 sequences
  estep_multinomial  K=32, V=64, B=1024, T=1000, the same two references
  batch_vb           5 batch-VB iterations at the estep_gaussian shape
  svi                20 windowed SVI steps on one T=1M chain, B=1024, L=50,
                     b=10
  long_chain         streaming E-step and decode of one T=10M chain, and the
                     fused tier against the two-phase tier at T=1M

--four-cards runs only the multi-device paths, each against the same
computation on one card: the data-parallel minibatch SVI step at B=4096 on a
4-card `data` mesh, and the time-sharded fused VB step on a T=8M chain on a
4-card `time` mesh.

Every phase raises on failure; the script exits non-zero and prints no
result line then. The last line of a passing run is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Usage: python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel(a, b) -> float:
    """max |a - b| / max |b| over the whole array."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def report(phase: str, t0: float, **metrics) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 2),
                      **metrics}), flush=True)


def require_gpu(n: int):
    """The devices JAX runs on; exit non-zero unless they are >= n GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < n:
        sys.exit(
            f"chip_smoke: needs {n} GPU(s); JAX found {len(devices)} "
            f"{devices[0].platform!r} device(s)"
        )
    return devices


def phase_device(n: int):
    devices = require_gpu(n)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for line in card.splitlines():
        print(line, flush=True)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')}", flush=True)
    return devices


def phase_gpu_tests() -> None:
    import pytest

    t0 = time.perf_counter()
    os.environ["PYSVIHMM_GPU_TESTS"] = "1"
    os.environ["PYSVIHMM_NO_EXT_BUILD"] = "1"
    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
        os.path.join(ROOT, "tests", "test_gpu_kernels.py"),
    ])
    check(rc == 0, f"GPU test cases (pytest exit {rc})")
    report("gpu_tests", t0)


def _oracle_fb(log_pi64, log_A64, ll64):
    """float64 oracle over sequences: (gamma (B,T,K), sum xi, log_z (B,))."""
    from pysvihmm_tpu.oracle import numpy_ref as oracle

    out = [oracle.forward_backward(log_pi64, log_A64, l) for l in ll64]
    return (np.stack([o[2] for o in out]), sum(o[3] for o in out),
            np.array([o[4] for o in out]))


def _compare_estep(name, t0, emission, params, obs, oracle_ll, oracle_stats):
    """The E-step at method="auto" against scan (all of obs) and against
    the float64 oracle (first 4 sequences)."""
    import jax

    from pysvihmm_tpu import messages
    from pysvihmm_tpu.engines.base import batch_local_step
    from pysvihmm_tpu.oracle import numpy_ref as oracle

    check(messages.resolve_method("auto") == "pallas", '"auto" resolves to the kernel')
    step = jax.jit(
        lambda p, o, m: batch_local_step(p, emission, o, m, need_gamma=False)[0],
        static_argnums=2,
    )
    got = jax.block_until_ready(step(params, obs, "auto"))
    ref = step(params, obs, "scan")
    vs_scan = {
        "log_z": abs(float(got.log_z) / float(ref.log_z) - 1.0),
        "trans": rel(got.trans, ref.trans),
        "init": rel(got.init, ref.init),
        "emit": max(rel(a, b) for a, b in zip(jax.tree.leaves(got.emit),
                                                jax.tree.leaves(ref.emit))),
    }
    # kernel and scan are both f32 over 1M steps, summed in another order
    for k, v in vs_scan.items():
        check(v <= 1e-4, f"{name} {k} vs scan: {v:.3g} > 1e-4")

    obs4 = obs[:4]
    st4, g4 = jax.jit(lambda p, o: batch_local_step(p, emission, o, "auto"))(params, obs4)
    log_pi64 = oracle.dir_elogp(np.asarray(params.init, np.float64))
    log_A64 = oracle.dir_elogp(np.asarray(params.trans, np.float64))
    ll64 = oracle_ll(params, np.asarray(obs4))
    g64, xi64, z64 = _oracle_fb(log_pi64, log_A64, ll64)
    emit64 = oracle_stats(g64, np.asarray(obs4))
    vs_oracle = {
        "log_z_rel": abs(float(st4.log_z) / z64.sum() - 1.0),
        "gamma_abs": float(np.abs(np.asarray(g4, np.float64) - g64).max()),
        "trans_rel": rel(st4.trans, xi64),
        "emit_rel": max(rel(a, b) for a, b in zip(jax.tree.leaves(st4.emit), emit64)),
    }
    # acceptance bounds: f32 likelihoods and recursion against float64
    bounds = {"log_z_rel": 1e-5, "gamma_abs": 1e-4, "trans_rel": 1e-4, "emit_rel": 1e-4}
    for k, v in vs_oracle.items():
        check(v <= bounds[k], f"{name} {k} vs f64 oracle: {v:.3g} > {bounds[k]}")
    report(name, t0, B=obs.shape[0], T=obs.shape[1], K=params.init.shape[0],
           vs_scan=vs_scan, vs_oracle=vs_oracle)


def phase_estep_gaussian(seed: int):
    import jax

    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.oracle import numpy_ref as oracle

    t0 = time.perf_counter()
    K, D, B, T = 64, 8, 1024, 1000
    obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(seed), K, D, B, T)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(seed + 1), prior, GaussianNIW, obs)

    def oracle_ll(p, y):
        e = [np.asarray(x, np.float64) for x in (p.emit.mean, p.emit.kappa,
                                                 p.emit.nu, p.emit.psi)]
        return np.stack([oracle.niw_expected_log_likelihood(*e, yb) for yb in y])

    def oracle_stats(g, y):
        y = y.astype(np.float64)
        return [g.sum((0, 1)), np.einsum("btk,btd->kd", g, y),
                np.einsum("btk,btd,bte->kde", g, y, y)]

    _compare_estep("estep_gaussian", t0, GaussianNIW, params, obs,
                   oracle_ll, oracle_stats)
    return prior, params, obs


def phase_estep_multinomial(seed: int) -> None:
    import jax

    from pysvihmm_tpu.data.synthetic import gen_multinomial_dataset
    from pysvihmm_tpu.distributions import MultinomialDirichlet
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.oracle import numpy_ref as oracle

    t0 = time.perf_counter()
    K, V, B, T = 32, 64, 1024, 1000
    obs, _, _ = gen_multinomial_dataset(jax.random.PRNGKey(seed + 10), K, V, B, T)
    prior = make_prior(K, MultinomialDirichlet, num_symbols=V)
    params = init_params(jax.random.PRNGKey(seed + 11), prior, MultinomialDirichlet, obs)

    def oracle_ll(p, y):
        elogphi = oracle.dir_elogp(np.asarray(p.emit, np.float64))  # (K, V)
        return np.stack([elogphi[:, yb].T for yb in y])

    def oracle_stats(g, y):
        return [np.einsum("btk,btv->kv", g, np.eye(V)[y])]

    _compare_estep("estep_multinomial", t0, MultinomialDirichlet, params, obs,
                   oracle_ll, oracle_stats)


def phase_batch_vb(prior, params, obs) -> None:
    import jax

    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines import batch_vb

    t0 = time.perf_counter()
    fit = jax.jit(lambda p, pr, o: batch_vb.fit(p, pr, o, GaussianNIW, num_iters=5))
    _, elbos = fit(params, prior, obs)
    e = np.asarray(elbos, np.float64)
    check(bool(np.isfinite(e).all()), f"batch-VB ELBO finite: {e}")
    # coordinate ascent never lowers the ELBO; 1e-5 relative is f32 slack
    drops = np.diff(e) / np.abs(e[:-1])
    check(bool((drops >= -1e-5).all()), f"batch-VB ELBO non-decreasing: {e}")
    report("batch_vb", t0, elbo=e.tolist())


def phase_svi(seed: int) -> None:
    import jax

    from pysvihmm_tpu import messages
    from pysvihmm_tpu.data.synthetic import gen_gaussian_chain
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines import svi
    from pysvihmm_tpu.models.hmm import init_params, make_prior

    t0 = time.perf_counter()
    K, D, T, B, L, b = 64, 8, 1_000_000, 1024, 50, 10
    chain, _, _ = gen_gaussian_chain(jax.random.PRNGKey(seed + 20), K, D, T)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(seed + 21), prior, GaussianNIW,
                         chain[None, :100_000])
    cfg = svi.SVIConfig(batch_size=B, subchain_len=L, buffer=b)
    check(messages.plan_window("auto", L, b)[0] == "pallas", "SVI runs the kernel")
    step = svi.make_step(GaussianNIW, cfg, T)
    state = svi.init_state(params, jax.random.PRNGKey(seed + 22))
    elbos, min_eig = [], np.inf
    for _ in range(20):
        state, metrics = step(state, prior, chain)
        elbos.append(float(metrics["noisy_elbo"]))
        eig = np.linalg.eigvalsh(np.asarray(state.params.emit.psi, np.float64))
        min_eig = min(min_eig, float(eig.min()))
        check(np.isfinite(elbos[-1]), f"SVI noisy ELBO finite at step {len(elbos)}")
        check(eig.min() > 0.0, f"NIW psi positive definite at step {len(elbos)}")
    report("svi", t0, T=T, B=B, W=L + 2 * b, steps=20, noisy_elbo=elbos[-1],
           min_psi_eig=min_eig)


def phase_long_chain(seed: int) -> None:
    import jax

    from pysvihmm_tpu.data.synthetic import gen_gaussian_chain
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines.base import long_chain_decode, long_chain_local_stats
    from pysvihmm_tpu.models.hmm import init_params, make_prior

    t0 = time.perf_counter()
    K, D, T = 64, 8, 10_000_000
    chain, _, _ = gen_gaussian_chain(jax.random.PRNGKey(seed + 30), K, D, T)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(seed + 31), prior, GaussianNIW,
                         chain[None, :100_000])
    stats_fn = jax.jit(lambda p, c, impl: long_chain_local_stats(p, GaussianNIW, c, impl=impl),
                       static_argnums=2)
    st = stats_fn(params, chain, "fused")
    z = np.asarray(jax.jit(lambda p, c: long_chain_decode(p, GaussianNIW, c))(params, chain))
    check(np.isfinite(float(st.log_z)), "T=10M log Z finite")
    # each pairwise marginal sums to 1 and each gamma_t too
    check(abs(float(st.trans.sum()) / (T - 1) - 1.0) < 1e-3, "sum xi == T-1")
    check(abs(float(st.emit.n.sum()) / T - 1.0) < 1e-3, "sum gamma == T")
    check(z.shape == (T,) and z.min() >= 0 and z.max() < K, "decode is (T,) in [0, K)")

    head = chain[:1_000_000]
    fused = float(stats_fn(params, head, "fused").log_z)
    twophase = float(stats_fn(params, head, "twophase").log_z)
    diff = abs(fused / twophase - 1.0)
    # two f32 streaming tiers over 1M steps, summed in another order
    check(diff <= 1e-5, f"fused vs twophase log Z at T=1M: {diff:.3g} > 1e-5")
    report("long_chain", t0, T=T, K=K, log_z=float(st.log_z),
           states_used=int(np.unique(z).size), fused_vs_twophase_T1M=diff)


def phase_dp_svi(seed: int, devices) -> None:
    import jax
    import jax.numpy as jnp

    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines import svi
    from pysvihmm_tpu.engines.base import batch_local_step
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.parallel.data_parallel import (
        default_devices,
        make_dp_minibatch_svi_step,
        make_dp_streamed_svi_step,
        make_mesh,
        shard_batch,
        sharded_local_step,
    )

    t0 = time.perf_counter()
    check(len(default_devices()) == 4 and default_devices()[3] == devices[3],
          "default_devices() returns all four cards")
    K, D, N, T, B = 64, 8, 16384, 1000, 4096
    obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(seed + 40), K, D, N, T)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(seed + 41), prior, GaussianNIW, obs[:256])
    mesh4, mesh1 = make_mesh(4), make_mesh(1)

    # summed statistics of one B=4096 batch: 4 cards vs 1 card
    batch = obs[:B]
    stats4 = jax.jit(lambda p, o: sharded_local_step(p, GaussianNIW, o, mesh4))(
        params, shard_batch(batch, mesh4))
    stats1 = jax.jit(lambda p, o: batch_local_step(p, GaussianNIW, o, need_gamma=False)[0])(
        params, batch)
    d_stats = max(rel(a, b) for a, b in zip(jax.tree.leaves(stats4), jax.tree.leaves(stats1)))
    check(d_stats <= 1e-5, f"4-card vs 1-card summed stats: {d_stats:.3g} > 1e-5")

    # the minibatch SVI step: each card draws B/4 rows of its own shard; the
    # 1-card reference runs the same rows through the streamed step
    cfg = svi.SVIConfig(batch_size=B)
    state = svi.init_state(params, jax.random.PRNGKey(seed + 42))
    step4 = make_dp_minibatch_svi_step(GaussianNIW, cfg, N, mesh4)
    new4, m4 = step4(state, prior, shard_batch(obs, mesh4))
    _, k_step = jax.random.split(state.key)
    rows = jnp.concatenate([
        d * (N // 4) + jax.random.randint(jax.random.fold_in(k_step, d), (B // 4,), 0, N // 4)
        for d in range(4)
    ])
    step1 = make_dp_streamed_svi_step(GaussianNIW, cfg, N, mesh1)
    new1, m1 = step1(state, prior, obs[rows])
    d_params = max(rel(a, b) for a, b in zip(jax.tree.leaves(new4.params),
                                             jax.tree.leaves(new1.params)))
    # the NIW update subtracts kappa m m^T from the summed second moments,
    # which magnified a 2e-7 stats difference a hundredfold on 4 virtual
    # CPU devices
    check(d_params <= 1e-3, f"4-card vs 1-card SVI params: {d_params:.3g} > 1e-3")
    d_elbo = abs(float(m4["noisy_elbo"]) / float(m1["noisy_elbo"]) - 1.0)
    check(d_elbo <= 1e-5, f"4-card vs 1-card noisy ELBO: {d_elbo:.3g} > 1e-5")
    report("dp_svi", t0, B=B, N=N, T=T, K=K, stats_vs_1card=d_stats,
           params_vs_1card=d_params, noisy_elbo_vs_1card=d_elbo)


def phase_ts_vb(seed: int) -> None:
    import jax

    from pysvihmm_tpu.data.synthetic import gen_gaussian_chain
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines.base import elbo_from_stats, long_chain_local_stats
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.parallel.time_parallel import (
        make_time_mesh,
        make_ts_stream_vb_step,
        shard_chain,
    )

    t0 = time.perf_counter()
    K, D, T = 64, 8, 8_000_000
    chain, _, _ = gen_gaussian_chain(jax.random.PRNGKey(seed + 50), K, D, T)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(seed + 51), prior, GaussianNIW,
                         chain[None, :100_000])
    mesh4 = make_time_mesh(4)
    step = make_ts_stream_vb_step(GaussianNIW, mesh4, impl="fused")
    _, elbo4 = step(params, prior, shard_chain(chain, mesh4))
    st1 = jax.jit(lambda p, c: long_chain_local_stats(p, GaussianNIW, c, impl="fused"))(
        params, chain)
    elbo1 = float(elbo_from_stats(params, prior, GaussianNIW, st1.log_z))
    diff = abs(float(elbo4) / elbo1 - 1.0)
    # the same f32 streaming sweep, split at 3 tile boundaries
    check(diff <= 1e-5, f"4-card vs 1-card ELBO at T=8M: {diff:.3g} > 1e-5")
    report("ts_vb", t0, T=T, K=K, elbo=float(elbo4), elbo_vs_1card=diff)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card paths, each against one card")
    args = ap.parse_args(argv)

    devices = phase_device(4 if args.four_cards else 1)
    sys.path.insert(0, ROOT)
    from pysvihmm_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.four_cards:
        phase_dp_svi(args.seed, devices)
        phase_ts_vb(args.seed)
    else:
        phase_gpu_tests()
        prior, params, obs = phase_estep_gaussian(args.seed)
        phase_estep_multinomial(args.seed)
        phase_batch_vb(prior, params, obs)
        phase_svi(args.seed)
        phase_long_chain(args.seed)

    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
