#!/bin/sh
# SMOKE TIER (<2 min on this host): the commit gate. Green here is required
# before ANY snapshot commit; `python -m pytest tests/ -q` (the full tier,
# ~20 min) is the release bar. Covers every layer cheaply:
#   messages       - scan/assoc/blocked FB parity vs the f64 oracle
#   distributions  - conjugate-family golden tests vs scipy closed forms
#   native_ext     - the C forward-backward extension (built by conftest)
#   fb_kernel      - the forward-backward kernel (interpreter) vs the f64
#                    oracle, and its lowering for CUDA (no card needed)
#   smoke          - one tiny end-to-end engine fit per family
set -e
cd "$(dirname "$0")/.."
exec python -m pytest \
    tests/test_messages.py \
    tests/test_distributions.py \
    tests/test_native_ext.py \
    tests/test_fb_kernel.py \
    tests/test_smoke.py \
    -q "$@"
