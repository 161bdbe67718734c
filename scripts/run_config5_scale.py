"""BASELINE config 5 at real scale: DP SVI over a disk-resident corpus.

The CI-scale form (run_baseline_configs.py, config 5) keeps the corpus in
device memory; this runner streams it from disk:

  1. writes an (N, T, D) float32 corpus to a .npy (chunked device
     generation -> memmap; the full corpus never sits in host RAM),
  2. streams shuffled, globally-sharded batches through
     ShardedSequenceLoader.from_npy (memmap: the OS pages in only the
     touched rows),
  3. runs make_dp_streamed_svi_step (shard-parallel local steps + psum'd
     stats + elastic-step-size natural-gradient update) for --steps,
  4. reports sequence throughput and end quality (Hamming on a held slice
     after Hungarian matching + held-out predictive LL per obs).

Defaults: N=200k sequences x T=128 x D=4, K=8, B=512 (N scales to 1M with
--num-seqs; 1M x 128 x 4 f32 = 2 GB on disk). One card or a mesh — the
same code path the multi-host loader uses.

Usage: python scripts/run_config5_scale.py [--num-seqs 200000] [--steps 300]
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
    ap.add_argument("--num-seqs", type=int, default=200_000)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--obs-dim", type=int, default=4)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--corpus", type=str,
                    default=str(Path(__file__).resolve().parent.parent
                                / "build" / "config5_corpus.npy"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--gen", choices=("device", "host"), default="device",
        help="corpus generation: 'device' draws chunks with gen_data on the "
        "accelerator (exact test-suite semantics); 'host' samples the same model (true params still "
        "drawn via make_gaussian_params) with vectorized NumPy — the "
        "covariances are spherical cov_scale*I, so host sampling is exact "
        "and runs at disk speed (needed for the 32 GB north-star corpus).",
    )
    ap.add_argument(
        "--reuse-corpus", action="store_true",
        help="skip generation and stream an existing --corpus file "
        "(quality probes need the same seed the corpus was written with)",
    )
    ap.add_argument(
        "--checkpoint-dir", type=str, default=None,
        help="periodic atomic checkpoints + resume-from-latest via "
        "engines/trainer.py (the fault-tolerance layer); a killed run "
        "restarted with the same dir resumes mid-corpus exactly "
        "(loader position is a pure function of the checkpointed step)",
    )
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument(
        "--gen-only", action="store_true",
        help="write the corpus and exit (run under JAX_PLATFORMS=cpu to "
        "pre-generate while the chip is busy; fit later with "
        "--reuse-corpus)",
    )
    args = ap.parse_args(argv)

    import jax

    from pysvihmm_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from pysvihmm_tpu.data.loader import ShardedSequenceLoader
    from pysvihmm_tpu.data.synthetic import gen_data, make_gaussian_params
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines import svi
    from pysvihmm_tpu.engines.base import decode, predictive_log_likelihood
    from pysvihmm_tpu.eval.metrics import hamming_error
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.parallel import make_dp_streamed_svi_step, make_mesh

    N, T, D, K, B = args.num_seqs, args.seq_len, args.obs_dim, args.K, args.batch_size

    # 1. chunked corpus generation straight into a disk memmap. All chunks
    # share ONE true parameter draw (same key into gen_*_dataset's param
    # sampling via fixed param_key) so the corpus is one model's data.
    t0 = time.perf_counter()
    chunk = 16_384
    z_head = None
    true_params = make_gaussian_params(
        jax.random.PRNGKey(args.seed), K, D, mean_scale=6.0, cov_scale=0.3
    )
    if args.reuse_corpus:
        out = np.load(args.corpus, mmap_mode="r")
        assert out.shape == (N, T, D), f"corpus shape {out.shape} != {(N, T, D)}"
        # replay chunk 0's STATE draws only (they precede the emission
        # normals in the host generator's rng stream, so a fresh
        # rng(seed+1) reproduces them exactly)
        pi = np.asarray(true_params.pi, np.float64)
        A_cum = np.cumsum(np.asarray(true_params.A, np.float64), axis=1)
        rng = np.random.default_rng(args.seed + 1)
        n = min(chunk, N)
        z = np.empty((n, T), np.int32)
        z[:, 0] = rng.choice(K, size=n, p=pi / pi.sum())
        u = rng.random((n, T - 1))
        for t in range(1, T):
            z[:, t] = (A_cum[z[:, t - 1]] < u[:, t - 1, None]).sum(axis=1)
        z_head = z[:512]
    elif args.gen == "host":
        out = np.lib.format.open_memmap(
            args.corpus, mode="w+", dtype=np.float32, shape=(N, T, D)
        )
        pi = np.asarray(true_params.pi, np.float64)
        A = np.asarray(true_params.A, np.float64)
        mu = np.asarray(true_params.theta[0], np.float32)
        # make_gaussian_params covariances are spherical cov_scale * I;
        # recover the scalar from the (K, D, D) array's [0, 0, 0] entry
        sd = float(np.sqrt(np.asarray(true_params.theta[1])[0, 0, 0]))
        A_cum = np.cumsum(A, axis=1)
        rng = np.random.default_rng(args.seed + 1)
        for s in range(0, N, chunk):
            n = min(chunk, N - s)
            z = np.empty((n, T), np.int32)
            z[:, 0] = rng.choice(K, size=n, p=pi / pi.sum())
            u = rng.random((n, T - 1))
            for t in range(1, T):
                # inverse-CDF draw per sequence from its current state's row
                z[:, t] = (
                    A_cum[z[:, t - 1]] < u[:, t - 1, None]
                ).sum(axis=1)
            out[s : s + n] = mu[z] + sd * rng.standard_normal(
                (n, T, D), np.float32
            )
            if z_head is None:
                z_head = z[:512].copy()
    else:
        out = np.lib.format.open_memmap(
            args.corpus, mode="w+", dtype=np.float32, shape=(N, T, D)
        )
        for s in range(0, N, chunk):
            n = min(chunk, N - s)
            # one true parameter draw for the whole corpus; the chunk index
            # folds into the sequence-sampling stream only
            from pysvihmm_tpu.distributions import GaussianNIW as _G

            obs_c, z_c = gen_data(
                jax.random.fold_in(jax.random.PRNGKey(args.seed + 1), s),
                true_params, _G, num_seqs=n, T=T,
            )
            out[s : s + n] = np.asarray(obs_c, np.float32)
            if z_head is None:
                z_head = np.asarray(z_c[:512])
    if not args.reuse_corpus:
        out.flush()
    gen_wall = time.perf_counter() - t0
    size_gb = N * T * D * 4 / 1e9
    if args.gen_only:
        print(json.dumps({
            "config": 5, "phase": "gen_only", "N": N, "T": T, "D": D,
            "corpus_gb": round(size_gb, 2), "gen_wall_s": round(gen_wall, 1),
            "corpus": args.corpus,
        }), flush=True)
        return

    # 2-3. stream + fit
    mesh = make_mesh()
    cfg = svi.SVIConfig(batch_size=B, tau=10.0, kappa=0.6, adaptive=True)
    loader = ShardedSequenceLoader.from_npy(args.corpus, mesh, batch_per_host=B,
                                            seed=args.seed)
    head = np.asarray(out[:512])  # quality probe slice (shares the memmap)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    p0 = init_params(jax.random.PRNGKey(args.seed + 2), prior, GaussianNIW,
                     jnp.asarray(head))
    state = svi.init_state(p0, jax.random.PRNGKey(args.seed + 3), adaptive=True)
    step = make_dp_streamed_svi_step(GaussianNIW, cfg, num_seqs=N, mesh=mesh)

    # Fit through the fault-tolerant trainer: periodic
    # atomic checkpoints + resume-from-latest; the loader's resumable
    # stream() re-derives the exact mid-corpus position from the restored
    # step counter. First segment (1 step) pays the compile (or fast-
    # forwards past it on resume) so the timed segment is steady-state.
    from pysvihmm_tpu.engines import trainer
    from pysvihmm_tpu.utils.logging import MetricsLogger

    log = MetricsLogger(echo=True)
    state = trainer.train_streamed(
        step, state, prior, loader, 1,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    jax.block_until_ready(state.params)
    resumed_from = int(np.asarray(state.step))
    t0 = time.perf_counter()
    state = trainer.train_streamed(
        step, state, prior, loader, args.steps,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        log=log, log_every=max(1, args.steps // 4),
        resume=False,  # state already restored by the first segment
    )
    jax.block_until_ready(state.params)
    fit_wall = time.perf_counter() - t0
    done = int(np.asarray(state.step)) - resumed_from

    # 4. quality
    z_hat = np.asarray(decode(state.params, GaussianNIW, jnp.asarray(head)))
    ham = hamming_error(z_hat.reshape(-1), z_head.reshape(-1), K)
    held = jnp.asarray(out[N - 256 :])
    pll = float(predictive_log_likelihood(state.params, GaussianNIW, held)) / held[..., 0].size

    print(json.dumps({
        "config": 5, "scale": "disk-streamed",
        "N": N, "T": T, "D": D, "K": K, "B": B,
        "corpus_gb": round(size_gb, 2), "gen_wall_s": round(gen_wall, 1),
        "steps": done, "resumed_from": resumed_from,
        "fit_wall_s": round(fit_wall, 1),
        "seqs_per_s": round(done * B / fit_wall, 1) if done else None,
        "hamming": ham, "pred_ll_per_obs": round(pll, 4),
        "devices": int(mesh.devices.size),
        "checkpoint_dir": args.checkpoint_dir,
    }), flush=True)


if __name__ == "__main__":
    main()
