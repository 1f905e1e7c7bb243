"""PyTorch/CUDA port of vae_hmc_tpu for NVIDIA Hopper (H100).

The JAX package ``vae_hmc_tpu`` is the reference; this package reproduces
its main path (synthetic audio -> log-mel -> conv multimodal VAE -> KMeans
-> silhouette / Davies-Bouldin / ARI) in PyTorch, with the two Pallas TPU
kernels of that path rewritten by hand in CUDA C++ (``csrc/``).

It imports ``torch`` and numpy only: never ``jax`` and never the JAX
package, whatever it needs from there is copied into this package.

Device rule: every entry point takes ``device=`` and defaults to
``"cuda"``; without a GPU it raises unless the caller passes ``"cpu"``
(see ``core.device``).
"""

__version__ = "0.1.0"
