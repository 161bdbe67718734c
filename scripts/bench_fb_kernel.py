"""Time the forward-backward kernel against `lax.scan` on the GPU.

Two places, as the E-step's users meet them:
  * estep: the batched E-step at K=64, D=8, B=1024, T=1000 (full
    `batch_local_step`, and the recursion alone on fixed likelihoods);
  * svi: the windowed SVI step at B=1024, L=50, b=10 (W=70), K=64, D=8.

Each timing is the median of --runs runs (parent order alternates so
neither method always runs first); every run chains --iters steps in one
jitted `lax.scan` with a 1e-30 parameter perturbation, so XLA cannot hoist
the likelihoods out of the loop. Also reports the kernel's error against
the float64 oracle on 4 sequences for each precision / block variant.

Usage: python scripts/bench_fb_kernel.py [--runs N] [--iters N]
                                         [--variants] [--skip-svi]
Prints one JSON line per measurement; exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def emit(rec):
    print(json.dumps(rec), flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def timed(fns, args, runs):
    """{name: [seconds per call]} over `runs` interleaved rounds."""
    import jax

    for fn in fns.values():
        jax.block_until_ready(fn(*args))  # compile + warm-up
    names = list(fns)
    out = {n: [] for n in names}
    for r in range(runs):
        order = names if r % 2 == 0 else names[::-1]
        for n in order:
            t0 = time.perf_counter()
            jax.block_until_ready(fns[n](*args))
            out[n].append(time.perf_counter() - t0)
    return out


def summarize(name, secs, per, extra=None):
    ms = [s / per * 1e3 for s in secs]
    rec = {"name": name, "ms_median": statistics.median(ms),
           "ms_min": min(ms), "ms_max": max(ms), "runs": len(ms)}
    rec.update(extra or {})
    emit(rec)
    return rec


def main():
    args = sys.argv[1:]

    def opt(flag, default):
        if flag in args:
            return int(args[args.index(flag) + 1])
        return default

    runs, iters = opt("--runs", 7), opt("--iters", 10)

    import jax
    import jax.numpy as jnp
    from jax import lax

    from pysvihmm_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform!r}")
    emit({"card": card(), "platform": dev.platform, "kind": dev.device_kind,
          "count": len(jax.devices()), "XLA_FLAGS": os.environ.get("XLA_FLAGS", "")})

    from pysvihmm_tpu import messages
    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines import svi
    from pysvihmm_tpu.engines.base import batch_local_step
    from pysvihmm_tpu.messages.pallas_fb import pallas_forward_backward_batched
    from pysvihmm_tpu.models.hmm import expected_log_params, init_params, make_prior
    from pysvihmm_tpu.oracle import numpy_ref as oracle
    from pysvihmm_tpu.utils.precision import f32_matmuls

    K, D, B, T = 64, 8, 1024, 1000
    obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, B, T)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
    log_pi, log_A = expected_log_params(params)
    ll = jax.jit(f32_matmuls(GaussianNIW.expected_log_likelihood))(params.emit, obs)

    # --- accuracy of each kernel variant against the f64 oracle ----------
    lp64, lA64 = np.asarray(log_pi, np.float64), np.asarray(log_A, np.float64)
    ll64 = np.asarray(ll[:4], np.float64)
    ref = [oracle.forward_backward(lp64, lA64, ll64[b]) for b in range(4)]
    z64 = np.array([r[4] for r in ref])
    g64 = np.stack([r[2] for r in ref])
    xi64 = sum(r[3] for r in ref)
    hi, x3 = lax.Precision.HIGHEST, lax.DotAlgorithmPreset.TF32_TF32_F32_X3
    variants = {"default": {}}
    if "--variants" in args:
        for b, p in [(8, hi), (32, hi), (16, x3)]:
            name = f"{'tf32x3' if p is x3 else 'highest'}_b{b}"
            variants[name] = dict(block_b=b, precision=p)
    for name, kw in list(variants.items()):
        try:
            fb = pallas_forward_backward_batched(log_pi, log_A, ll[:4], **kw)
        except Exception as e:  # a variant Triton refuses is a finding
            emit({"name": f"accuracy_{name}", "error": str(e)[:300]})
            del variants[name]
            continue
        emit({"name": f"accuracy_{name}",
              "logz_rel": float(np.max(np.abs(np.asarray(fb.log_z) - z64) / np.abs(z64))),
              "gamma_abs": float(np.max(np.abs(np.asarray(fb.gamma) - g64))),
              "xi_rel": float(np.max(np.abs(np.asarray(fb.trans_stats) - xi64)) / np.max(np.abs(xi64)))})

    # --- recursion alone on fixed likelihoods ------------------------------
    def recursion(fn, lp):
        @jax.jit
        def run(lA, ll_):
            def body(c, _):
                r = fn(lp, lA + c * 1e-30, ll_)
                tot = r.log_z.sum() + r.trans_stats.sum() + r.gamma[:, -1].sum()
                return c + tot * 0.0, None
            return lax.scan(body, jnp.zeros(()), None, length=iters)[0]
        return run

    rec_fns = {"recursion_scan": recursion(f32_matmuls(
        lambda a, b, c: messages.e_step_batched(a, b, c, method="scan")), log_pi)}
    for name, kw in variants.items():
        rec_fns[f"recursion_{name}"] = recursion(
            lambda a, b, c, kw=kw: pallas_forward_backward_batched(a, b, c, **kw), log_pi)
    for n, s in timed(rec_fns, (log_A, ll), runs).items():
        summarize(n, s, iters, {"B": B, "T": T, "K": K})

    # --- full E-step through the engine entry point ------------------------
    def estep(method):
        @jax.jit
        def run(p, o):
            def body(c, _):
                pv = jax.tree.map(lambda x: x + c * 1e-30, p)
                st, _ = batch_local_step(pv, GaussianNIW, o, method, need_gamma=False)
                tot = st.log_z + st.trans.sum() + st.init.sum()
                tot = tot + sum(jnp.sum(x) for x in jax.tree.leaves(st.emit))
                return c + tot * 0.0, None
            return lax.scan(body, jnp.zeros(()), None, length=iters)[0]
        return run

    est = timed({"estep_scan": estep("scan"), "estep_pallas": estep("pallas")},
                (params, obs), runs)
    for n, s in est.items():
        summarize(n, s, iters, {"B": B, "T": T, "K": K, "D": D})

    # --- multinomial E-step: the likelihood + statistics share -----------
    from pysvihmm_tpu.data.synthetic import gen_multinomial_dataset
    from pysvihmm_tpu.distributions import MultinomialDirichlet

    Km, V = 32, 64
    obs_m, _, _ = gen_multinomial_dataset(jax.random.PRNGKey(5), Km, V, B, T)
    prior_m = make_prior(Km, MultinomialDirichlet, num_symbols=V)
    params_m = init_params(jax.random.PRNGKey(6), prior_m, MultinomialDirichlet, obs_m)
    lp_m, lA_m = expected_log_params(params_m)
    ll_m = jax.jit(f32_matmuls(MultinomialDirichlet.expected_log_likelihood))(
        params_m.emit, obs_m)

    def estep_m():
        @jax.jit
        def run(p, o):
            def body(c, _):
                pv = jax.tree.map(lambda x: x + c * 1e-30, p)
                st, _ = batch_local_step(pv, MultinomialDirichlet, o, "pallas",
                                         need_gamma=False)
                tot = st.log_z + st.trans.sum() + st.init.sum() + st.emit.sum()
                return c + tot * 0.0, None
            return lax.scan(body, jnp.zeros(()), None, length=iters)[0]
        return run

    rec_m = recursion(pallas_forward_backward_batched, lp_m)
    for n, s_ in timed({"multinomial_estep_pallas": estep_m()}, (params_m, obs_m), runs).items():
        summarize(n, s_, iters, {"B": B, "T": T, "K": Km, "V": V})
    for n, s_ in timed({"multinomial_recursion_pallas": rec_m}, (lA_m, ll_m), runs).items():
        summarize(n, s_, iters, {"B": B, "T": T, "K": Km})

    if "--skip-svi" in args:
        return
    # --- windowed SVI step -------------------------------------------------
    Tc, L, b, steps = 100_000, 50, 10, 20
    chain = gen_gaussian_dataset(jax.random.PRNGKey(3), K, D, 1, Tc)[0][0]
    p1 = init_params(jax.random.PRNGKey(4), prior, GaussianNIW, chain[None])
    cfg = svi.SVIConfig(batch_size=B, subchain_len=L, buffer=b)

    def svi_run(method):
        step = svi.make_step(GaussianNIW, cfg, Tc, method=method)

        @jax.jit
        def run(st):
            def body(s, _):
                s2, m = step(s, prior, chain)
                return s2, m["noisy_elbo"]
            return lax.scan(body, st, None, length=steps)[1]
        return run

    st0 = svi.init_state(p1, jax.random.PRNGKey(5))
    sv = timed({"svi_scan": svi_run("scan"), "svi_pallas": svi_run("pallas")},
               (st0,), runs)
    for n, s in sv.items():
        summarize(n, s, steps, {"B": B, "W": L + 2 * b, "K": K, "D": D})


if __name__ == "__main__":
    main()
