"""2-D projection dispatch: pca / umap / tsne, all first-party, on the
device (port of ``vae_hmc_tpu.viz.projections``).

The reference treats umap-learn as an optional host dependency and falls
back to t-SNE when it is missing (scripts 08:14-18, 14:13-25, 21:13-17).
UMAP is first-party here (``viz.umap``), so that fallback never triggers.
When umap-learn is installed, VAE_HMC_USE_UMAP_LEARN=1 prefers it (the
reference's behaviour, for diffing artifacts).

Optionally pre-projects high-dimensional inputs with PCA before UMAP or
t-SNE (reference 14:196-199).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from vae_hmc_tpu_torch.core.config import TsneConfig, UmapConfig
from vae_hmc_tpu_torch.core.device import as_rows
from vae_hmc_tpu_torch.ops.pca import PCA
from vae_hmc_tpu_torch.viz.tsne import tsne
from vae_hmc_tpu_torch.viz.umap import umap_2d

try:                                    # optional host package (ref 08:14-18)
    import umap as _umap_learn           # noqa: F401
    _HAVE_UMAP_LEARN = True
except ImportError:
    _HAVE_UMAP_LEARN = False


def use_umap_learn() -> bool:
    """umap-learn is installed and VAE_HMC_USE_UMAP_LEARN asks for it."""
    return _HAVE_UMAP_LEARN and bool(os.environ.get("VAE_HMC_USE_UMAP_LEARN"))


def reduce_2d(x, method: str = "umap",
              tsne_cfg: TsneConfig = TsneConfig(),
              umap_cfg: UmapConfig = UmapConfig(),
              pre_pca_dim: Optional[int] = None,
              device="cuda") -> Tuple[np.ndarray, str]:
    """(N, d) numpy or tensor -> (xy (N, 2) on the host,
    method_actually_used).  A tensor stays on its own device through PCA,
    UMAP and t-SNE; numpy goes to `device`."""
    x = as_rows(x, device)
    if pre_pca_dim and x.shape[1] > pre_pca_dim:
        # clamp by N for tiny runs; oversize k raises (sklearn parity)
        x = PCA(min(pre_pca_dim, int(x.shape[0]))).fit_transform(x)
    method = method.lower()
    if method == "pca":
        return PCA(2).fit_transform(x).cpu().numpy(), "pca"
    if method == "umap":
        if use_umap_learn():
            reducer = _umap_learn.UMAP(n_neighbors=umap_cfg.n_neighbors,
                                       min_dist=umap_cfg.min_dist,
                                       random_state=umap_cfg.seed)
            return np.asarray(reducer.fit_transform(x.cpu().numpy())), "umap"
        return umap_2d(x, n_neighbors=umap_cfg.n_neighbors,
                       min_dist=umap_cfg.min_dist,
                       seed=umap_cfg.seed), "umap"
    if method == "tsne":
        return tsne(x, tsne_cfg), "tsne"
    raise ValueError(f"unknown projection method {method!r}")
