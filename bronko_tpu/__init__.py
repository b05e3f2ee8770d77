"""bronko-tpu: a mapping-free viral variant caller on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of
treangenlab/bronko: reference genomes are k-merized into a
locality-collapsing bucket index; reads are k-mer counted and probed against
the index on-device; matched k-mers scatter into strand-aware pileup tensors;
a vectorized statistical caller emits VCFs of major variants and iSNVs.

Importing this package enables JAX x64 mode (the k-mer/bucket word size is
64-bit). Do it before creating any JAX arrays.
"""

import os

from bronko_tpu.consts import BRONKO_TPU_VERSION as __version__  # noqa: F401

# persistent compilation cache used when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed path inside the checkout (listed in .gitignore), so every process
# of this checkout finds what an earlier one compiled
DEFAULT_JAX_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _configure_jax() -> None:
    try:
        import jax
    except ImportError:  # pure host-side use (oracle, IO) works without jax
        return
    jax.config.update("jax_enable_x64", True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_JAX_CACHE_DIR)


_configure_jax()
