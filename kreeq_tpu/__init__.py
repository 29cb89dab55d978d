"""kreeq-tpu: a k-mer quality-evaluation engine in JAX.

A from-scratch re-architecture of the capabilities of vgl-hub/kreeq for
accelerators.  The compute path (canonical k-mer extraction, counting,
probing) runs as JAX/XLA programs — sorted-array tables + vectorized
probes replace the reference's 128-way parallel hash maps (reference:
include/kreeq.h:138-148), and device collectives replace its
file-based `union` merge (reference: src/graph-builder.cpp:297-351).

Keys are 64-bit reversible 2-bit packings of canonical k-mers
(first base in the low bits; A=0 C=1 G=2 T=3; canonical = min of the
packing of the k-mer and of its reverse complement), byte-compatible
with the on-disk `.kreeq` databases produced by the reference
(validated against testFiles/test1.kreeq).

The platform is JAX's own choice (`JAX_PLATFORMS`).
"""

import os as _os

import jax as _jax

# 64-bit keys (k <= 32 -> up to 64-bit packed k-mers) require x64 mode.
# Must be set before any JAX computation runs.
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: kernel shapes are stable across runs
# (fixed chunk sizes, power-of-two merge buckets), so repeat runs skip
# XLA compilation.  JAX itself honours JAX_COMPILATION_CACHE_DIR; when
# that is unset the cache lives at a fixed directory of the checkout
# (the path is part of the cache key, so it must not move).
# KREEQ_TPU_NO_COMPILE_CACHE=1 turns the cache off.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("KREEQ_TPU_NO_COMPILE_CACHE"):
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"
