"""Matmul precision policy for inference numerics.

Variational message passing compounds matmul rounding along the chain, and
its likelihood matmuls feed exp(): an f32 product is only as good as the
precision it runs at. On an H100, XLA lowers an f32 dot at JAX's default
precision, and also at ``"high"``, to TF32 (a 10-bit mantissa, 2^-11
relative rounding of each operand). Measured on the E-step's likelihood
form feats (1M x 45) @ W (45 x 64) (GaussianNIW, D=8, K=64) against
float64 (scripts/check_matmul_precision.py):

    precision           optimized HLO   max rel err   max abs err (nats)
    default             Triton gemm     2.8e-4        3.1
    "high"              cuBLAS gemm     2.8e-4        3.1
    "highest"           cuBLAS gemm     3.0e-7        3.4e-3
    TF32_TF32_F32_X3    Triton gemm     2.1e-7        2.3e-3
    BF16_BF16_F32_X3    Triton gemm     5.8e-6        6.3e-2

(default and "high" give the same error, the size of TF32 rounding.)

An error of 3 nats in a log-likelihood is a factor e^3 in a message, so
neither default nor "high" is acceptable anywhere on the inference path.
Full f32 ("highest") meets the ~5e-7 relative budget of a one-shot
likelihood form and costs little: these products are small beside the
sequential recursion.

Policy: every engine entry point traces under `f32_matmuls` ("float32":
IEEE f32 on the GPU, and the CPU executes f32 exactly anyway). The
forward-backward kernels (messages/pallas_fb.py) name their own dot
precision, since a Pallas kernel does not see this context.
"""

from __future__ import annotations

import functools

import jax


def f32_matmuls(fn):
    """Trace ``fn`` under full-f32 ("float32") matmul precision.

    Composes with `jax.jit` (apply below the jit decorator: the context
    governs the ops traced inside). Explicit per-op `precision=` arguments
    still win where set.
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapper
