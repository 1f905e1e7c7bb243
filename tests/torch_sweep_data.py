"""Test data of the port's sweep tests: three small representations of
hierarchical blobs with no pair distance near a DBSCAN eps of the grids."""
import numpy as np

SWEEP_EPS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
SUITE_EPS = (0.4, 0.6, 0.8, 1.0, 1.2)
GENRES = np.array(["Rock", "Pop", "Folk", "Jazz"])


def _min_gap(x: np.ndarray) -> float:
    """Smallest |d - eps| over the off-diagonal f64 distances and the eps
    of both grids."""
    x = x.astype(np.float64)
    d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    off = d[~np.eye(len(x), dtype=bool)]
    return min(float(np.abs(off - e).min()) for e in SWEEP_EPS + SUITE_EPS)


def hier_blobs(seed: int, d: int, n_per: int = 15, spread: float = 0.45,
               width: int = 0):
    """(8 n_per, d) float32 rows, 8 sub-blobs in 4 groups (genre = group):
    groups on orthonormal axes at radius 3 (4.2 apart; small norms keep
    the f32 cancellation error of |a|^2+|b|^2-2ab near 1e-5), sub-blob
    pairs 2.0, 1.6, 1.3 and 1.05 apart.  width > d: the rows are rotated
    into `width` dimensions (isotropic noise in all 300 dimensions would
    make every within-blob distance nearly equal, and ward's merges nearly
    tied).  Re-drawn from the next seed until no pair sits within 1e-4 of
    an eps."""
    for s in range(seed, seed + 200):
        rng = np.random.default_rng(s)
        axes, _ = np.linalg.qr(rng.normal(0, 1, (d, 4)))
        groups = 3.0 * axes.T
        dirs = rng.normal(0, 1, (4, d))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        centres = []
        for g, sep in enumerate((2.0, 1.6, 1.3, 1.05)):
            centres += [groups[g] + 0.5 * sep * dirs[g],
                        groups[g] - 0.5 * sep * dirs[g]]
        sub = np.repeat(np.arange(8), n_per)
        x = np.asarray(centres)[sub] + rng.normal(
            0, spread / np.sqrt(2 * d), (len(sub), d))
        if width:
            x = x @ np.linalg.qr(rng.normal(0, 1, (width, d)))[0].T
        x = x.astype(np.float32)
        if _min_gap(x) > 1e-4:
            return x, GENRES[sub // 2]
    raise AssertionError("no tie-free draw")


def reps_data():
    """Three representations in the shapes of the medium tier's (latents,
    a wide flat one, and a lyrics one with fewer rows), small."""
    ids = np.arange(1000, 1120)
    x_lat, genre = hier_blobs(1, 8)
    x_wide, _ = hier_blobs(2, 8, width=300)
    x_lyr, _ = hier_blobs(3, 24)
    keep = np.sort(np.random.default_rng(4).choice(120, 104, replace=False))
    return {"vae_mm_latents": (x_lat, ids),
            "baseline_mel_flat": (x_wide, ids),
            "baseline_lyrics_only": (x_lyr[keep], ids[keep])}, \
        {int(t): str(g) for t, g in zip(ids, genre)}
