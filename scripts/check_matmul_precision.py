"""What an f32 likelihood matmul becomes on the GPU at each precision.

Compiles the E-step's likelihood form feats (N, F) @ W (F, K) (GaussianNIW,
D=8: F=45, K=64) under each matmul precision, prints the gemm lines of the
optimized HLO (the cuBLAS / Triton call and its precision or algorithm),
and measures each result's error against float64: max |d| / max |ref| and
the max absolute error in nats (the quantity that enters exp() in the
forward-backward chain).

Usage: python scripts/check_matmul_precision.py [N]
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20
    K, D = 64, 8
    obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, 1, N)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
    feats = GaussianNIW.ell_features(obs[0])
    W = GaussianNIW.ell_feature_matrix(params.emit)
    ref = np.asarray(feats, np.float64) @ np.asarray(W, np.float64)

    cases = {
        "default": dict(precision=None),
        "high": dict(precision=lax.Precision.HIGH),
        "highest": dict(precision=lax.Precision.HIGHEST),
        "tf32_tf32_f32_x3": dict(precision=lax.DotAlgorithmPreset.TF32_TF32_F32_X3),
        "bf16_bf16_f32_x3": dict(precision=lax.DotAlgorithmPreset.BF16_BF16_F32_X3),
        "bf16_bf16_f32_x6": dict(precision=lax.DotAlgorithmPreset.BF16_BF16_F32_X6),
    }
    for name, kw in cases.items():
        fn = jax.jit(lambda a, b, kw=kw: jnp.dot(a, b, preferred_element_type=jnp.float32, **kw))
        try:
            comp = fn.lower(feats, W).compile()
        except Exception as e:  # report which presets this backend refuses
            print(json.dumps({"precision": name, "error": str(e)[:300]}), flush=True)
            continue
        hlo = comp.as_text()
        gemm = [l.strip()[:400] for l in hlo.splitlines()
                if re.search(r"custom-call|dot\(|fusion.*kind=k", l) and "ROOT" not in l[:6]]
        out = np.asarray(comp(feats, W), np.float64)
        print(json.dumps({
            "precision": name,
            "rel_err": float(np.abs(out - ref).max() / np.abs(ref).max()),
            "abs_err_nats": float(np.abs(out - ref).max()),
            "hlo": gemm[:4],
        }), flush=True)


if __name__ == "__main__":
    main()
