"""Figure writers matching the reference's output filenames (port of
``vae_hmc_tpu.viz.plots``, plus script 15's side-by-side figure).

Every writer takes data and a ``.png`` path.  matplotlib is imported when
a figure is drawn, with the Agg backend, so headless runs work and the
compute path never depends on it.  Where matplotlib is not installed, a
writer saves the figure's data instead, as ``<stem>.npz`` beside the PNG
it would have drawn, and returns that path; ``figure_kind()`` says which
of the two this process writes.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np


def _plt():
    """matplotlib.pyplot with the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def figure_kind() -> str:
    """"png" where matplotlib imports, else "npz"."""
    return "png" if _plt() is not None else "npz"


def _save(fig, path: Path, dpi: int = 200) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    import matplotlib.pyplot as plt
    plt.close(fig)
    return path


def _save_data(path: Path, **data) -> Path:
    """The figure's data as <stem>.npz beside the PNG path."""
    out = Path(path).with_suffix(".npz")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in data.items()})
    return out


def pca_variance_plot(explained_ratio: np.ndarray, path: Path,
                      title: str) -> Path:
    """Cumulative + per-component explained variance (reference 09:93-131)."""
    plt = _plt()
    if plt is None:
        return _save_data(path, explained_ratio=explained_ratio, title=title)
    fig, ax = plt.subplots(figsize=(10, 6))
    comp = np.arange(1, len(explained_ratio) + 1)
    ax.bar(comp, explained_ratio, alpha=0.6, label="per component")
    ax.plot(comp, np.cumsum(explained_ratio), "o-", color="tab:red",
            label="cumulative")
    ax.set_xlabel("principal component")
    ax.set_ylabel("explained variance ratio")
    ax.set_title(title)
    ax.legend()
    return _save(fig, path)


def scatter_2d(xy: np.ndarray, labels: np.ndarray, path: Path, title: str,
               noise_as_x: bool = False, legend_title: str = "cluster") -> Path:
    """Colored 2-D scatter (reference 08:122-131, 14:102-150, 21:96-98).

    noise_as_x: draw label==-1 points as grey 'x' (DBSCAN noise, 14:107-110).
    """
    labels = np.asarray(labels)
    plt = _plt()
    if plt is None:
        return _save_data(path, xy=xy, labels=labels, title=title)
    fig, ax = plt.subplots(figsize=(9, 7))
    uniq = [u for u in np.unique(labels) if not (noise_as_x and u == -1)]
    cmap = plt.get_cmap("tab10" if len(uniq) <= 10 else "tab20")
    for i, u in enumerate(uniq):
        m = labels == u
        ax.scatter(xy[m, 0], xy[m, 1], s=8, alpha=0.7,
                   color=cmap(i % cmap.N), label=str(u))
    if noise_as_x and np.any(labels == -1):
        m = labels == -1
        ax.scatter(xy[m, 0], xy[m, 1], s=10, marker="x", color="grey",
                   alpha=0.5, label="noise")
    ax.set_title(title)
    ax.legend(title=legend_title, markerscale=2, fontsize=8)
    return _save(fig, path)


def training_curves(history: Sequence[Dict], path: Path,
                    title: str = "training loss") -> Path:
    """total/recon/kl per epoch (reference 19:289-302 training_curve plots)."""
    epochs = [h["epoch"] for h in history]
    curves = {k: [h[k] for h in history] for k in ("total", "recon", "kl")}
    plt = _plt()
    if plt is None:
        return _save_data(path, epoch=epochs, title=title, **curves)
    fig, ax = plt.subplots(figsize=(9, 5))
    for k, v in curves.items():
        ax.plot(epochs, v, label=k)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.legend()
    return _save(fig, path)


def grouped_bars(rows: Sequence[Dict], group_key: str,
                 metric_keys: Sequence[str], path: Path, title: str) -> Path:
    """Grouped bar chart over methods x metrics (reference 22:179-199
    baseline_bars, 17:62-84 per-metric report bars)."""
    groups = [str(r[group_key]) for r in rows]
    values = {mk: [float(r.get(mk) if r.get(mk) is not None else np.nan)
                   for r in rows] for mk in metric_keys}
    plt = _plt()
    if plt is None:
        return _save_data(path, groups=groups, title=title, **values)
    fig, ax = plt.subplots(figsize=(10, 6))
    n_g, n_m = len(groups), len(metric_keys)
    width = 0.8 / n_m
    xs = np.arange(n_g)
    for j, mk in enumerate(metric_keys):
        ax.bar(xs + j * width, values[mk], width, label=mk)
    ax.set_xticks(xs + 0.4 - width / 2)
    ax.set_xticklabels(groups, rotation=20, ha="right", fontsize=8)
    ax.set_title(title)
    ax.legend()
    return _save(fig, path)


def stacked_bar_distribution(counts: np.ndarray, row_names: Sequence[str],
                             col_names: Sequence[str], path: Path,
                             title: str) -> Path:
    """Row-normalized stacked bars: cluster composition over genres/languages
    (reference 21:100-117)."""
    counts = np.asarray(counts, dtype=np.float64)
    frac = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1.0)
    plt = _plt()
    if plt is None:
        return _save_data(path, fraction=frac, row_names=list(row_names),
                          col_names=[str(c) for c in col_names], title=title)
    fig, ax = plt.subplots(figsize=(10, 6))
    bottom = np.zeros(len(row_names))
    cmap = plt.get_cmap("tab10")
    for j, cn in enumerate(col_names):
        ax.bar(row_names, frac[:, j], bottom=bottom, label=str(cn),
               color=cmap(j % cmap.N))
        bottom += frac[:, j]
    ax.set_ylabel("fraction")
    ax.set_title(title)
    ax.legend(fontsize=8, bbox_to_anchor=(1.02, 1.0), loc="upper left")
    return _save(fig, path)


def line_sweep(xs: Sequence[float], ys: Sequence[float], path: Path,
               xlabel: str, ylabel: str, title: str) -> Path:
    """Single line plot (reference 15:124-153 DBSCAN eps sweeps)."""
    plt = _plt()
    if plt is None:
        return _save_data(path, x=np.asarray(xs, np.float64),
                          y=np.asarray(ys, np.float64), xlabel=xlabel,
                          ylabel=ylabel, title=title)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(xs, ys, "o-")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(alpha=0.3)
    return _save(fig, path)


def recon_overlay(x: np.ndarray, xhat: np.ndarray, path: Path,
                  n_examples: int = 4, title: str = "reconstructions") -> Path:
    """Feature-vector reconstruction overlays (reference 19:304-334)."""
    n = min(n_examples, x.shape[0])
    plt = _plt()
    if plt is None:
        return _save_data(path, x=x[:n], xhat=xhat[:n], title=title)
    fig, axes = plt.subplots(n, 1, figsize=(10, 2.2 * n), squeeze=False)
    for i in range(n):
        ax = axes[i][0]
        ax.plot(x[i], label="input", lw=0.8)
        ax.plot(xhat[i], label="recon", lw=0.8)
        if i == 0:
            ax.set_title(title)
            ax.legend(fontsize=8)
    return _save(fig, path)


def side_by_side(rows: Sequence[Sequence[tuple]], path: Path,
                 dpi: int = 220) -> Path:
    """Script 15's grid (reference 15:96-121): rows[i][j] = (xy, labels,
    title) is the panel in row i, column j (three representations by the
    PCA and UMAP projections)."""
    n_rows, n_cols = len(rows), len(rows[0])
    plt = _plt()
    if plt is None:
        data = {}
        for i, row in enumerate(rows):
            for j, (xy, y, t) in enumerate(row):
                data[f"xy_{i}_{j}"], data[f"labels_{i}_{j}"] = xy, y
                data[f"title_{i}_{j}"] = t
        return _save_data(path, **data)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(12, 16), squeeze=False)
    for i, row in enumerate(rows):
        for j, (xy, y, t) in enumerate(row):
            axes[i, j].scatter(xy[:, 0], xy[:, 1], c=y, s=6, cmap="tab10")
            axes[i, j].set_title(t, fontsize=9)
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path

