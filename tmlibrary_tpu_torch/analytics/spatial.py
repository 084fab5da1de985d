"""Spatial statistics via summed-area tables (integral images).

Counterpart: ``tmlibrary_tpu/analytics/spatial.py``.  Object centroids
are binned onto a per-site grid (host numpy, the reference's float32
binning) and each grid becomes its 2-D prefix sum with two cumulative
sums on ``device``; any axis-aligned window sum is then four lookups::

    sum(grid[y0:y1, x0:x1]) = S[y1, x1] - S[y0, x1] - S[y1, x0] + S[y0, x0]

Two tables per site: object counts and "marked" counts (a caller-chosen
0/1 indicator), so local density and neighbourhood enrichment are
constant-time per object.  The tables hold integer counts in float32,
so every sum and lookup is exact on either device and equals the
reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmlibrary_tpu_torch.device import resolve_device

DEFAULT_GRID = 64


def _integral(grids: torch.Tensor) -> torch.Tensor:
    """(S, Gy, Gx) bin grids -> (S, Gy+1, Gx+1) summed-area tables with a
    zero top row and left column."""
    s = torch.cumsum(torch.cumsum(grids, dim=1), dim=2)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def _window_sums(tables: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    site, y0, x0, y1, x1 = windows.unbind(dim=1)
    t = tables[site]
    take = lambda y, x: t[torch.arange(len(site), device=t.device), y, x]  # noqa: E731
    return take(y1, x1) - take(y0, x1) - take(y1, x0) + take(y0, x0)


@dataclasses.dataclass
class SpatialIndex:
    """Per-site integral-image tables over binned object centroids."""

    site_ids: np.ndarray      # (S,) the distinct site_index values
    tables: torch.Tensor      # (S, Gy+1, Gx+1) float32: object counts
    mark_tables: torch.Tensor | None  # same shape: marked-object counts
    grid: tuple[int, int]     # (Gy, Gx)
    extent: tuple[float, float, float, float]  # y0, x0, y1, x1 in object units
    site_row: np.ndarray      # (N,) row in ``site_ids`` per object
    bins: np.ndarray          # (N, 2) each object's (by, bx) bin
    mark: np.ndarray | None = None  # (N,) the per-object mark indicator

    @property
    def n_marked(self) -> float:
        if self.mark_tables is None:
            return 0.0
        return float(self.mark_tables[:, -1, -1].double().sum())

    @property
    def n_objects(self) -> float:
        return float(self.tables[:, -1, -1].double().sum())

    def _sums(self, tables: torch.Tensor, windows) -> np.ndarray:
        w = torch.from_numpy(np.asarray(windows, np.int64)).to(tables.device)
        return _window_sums(tables, w).cpu().numpy()

    def window_counts(self, windows) -> np.ndarray:
        """Counts in explicit windows ``(site_row, y0, x0, y1, x1)`` in bin
        coordinates (half-open): four lookups each."""
        return self._sums(self.tables, windows)

    def mark_window_counts(self, windows) -> np.ndarray:
        if self.mark_tables is None:
            raise ValueError("spatial index built without a mark")
        return self._sums(self.mark_tables, windows)

    def neighborhood(self, radius_bins: int = 2) -> tuple[np.ndarray, np.ndarray | None]:
        """Per-object counts (and marked counts) in the square window of
        ``radius_bins`` bins around each object's own bin."""
        wins = _object_windows(self.site_row, self.bins, self.grid, radius_bins)
        counts = self.window_counts(wins)
        marked = self.mark_window_counts(wins) if self.mark_tables is not None else None
        return counts, marked


def _object_windows(site_row: np.ndarray, bins: np.ndarray, grid: tuple[int, int],
                    radius: int) -> np.ndarray:
    gy, gx = grid
    y0 = np.clip(bins[:, 0] - radius, 0, gy)
    y1 = np.clip(bins[:, 0] + radius + 1, 0, gy)
    x0 = np.clip(bins[:, 1] - radius, 0, gx)
    x1 = np.clip(bins[:, 1] + radius + 1, 0, gx)
    return np.stack([site_row, y0, x0, y1, x1], axis=1).astype(np.int32)


def build_index(site_index, centroids, mark=None, grid: int | tuple[int, int] = DEFAULT_GRID,
                device: "str | torch.device" = "cuda") -> SpatialIndex:
    """Bin object centroids per site and build the integral tables on
    ``device``.  ``site_index`` -1 (spatial-mosaic rows) is one logical
    site; the grid extent is the global centroid bounding box, so bins
    are comparable across the sites of one experiment."""
    dev = resolve_device(device)
    site_index = np.asarray(site_index, np.int64)
    centroids = np.asarray(centroids, np.float32)
    if centroids.ndim != 2 or centroids.shape[1] != 2 or not len(centroids):
        raise ValueError("centroids must be a non-empty (N, 2) array")
    gy, gx = (grid, grid) if isinstance(grid, int) else grid
    site_ids, site_row = np.unique(site_index, return_inverse=True)
    y, x = centroids[:, 0], centroids[:, 1]
    ylo, xlo = float(y.min()), float(x.min())
    yhi = float(y.max()) + 1e-6
    xhi = float(x.max()) + 1e-6
    by = np.clip(((y - ylo) / max(yhi - ylo, 1e-6) * gy).astype(np.int64), 0, gy - 1)
    bx = np.clip(((x - xlo) / max(xhi - xlo, 1e-6) * gx).astype(np.int64), 0, gx - 1)
    flat = (site_row * gy + by) * gx + bx
    n_cells = len(site_ids) * gy * gx

    def tables(weights=None) -> torch.Tensor:
        g = np.bincount(flat, weights=weights, minlength=n_cells).astype(np.float32)
        return _integral(torch.from_numpy(g.reshape(len(site_ids), gy, gx)).to(dev))

    mark_np = None if mark is None else np.asarray(mark, np.float32)
    return SpatialIndex(
        site_ids=site_ids, tables=tables(),
        mark_tables=None if mark_np is None else tables(mark_np),
        grid=(gy, gx), extent=(ylo, xlo, yhi, xhi),
        site_row=site_row.astype(np.int32),
        bins=np.stack([by, bx], axis=1).astype(np.int32),
        mark=mark_np,
    )


def density(index: SpatialIndex, radius_bins: int = 2) -> np.ndarray:
    """Per-object local density: neighbours per bin in the square window
    around each object (the object itself excluded)."""
    counts, _ = index.neighborhood(radius_bins)
    wins = _object_windows(index.site_row, index.bins, index.grid, radius_bins)
    area = ((wins[:, 3] - wins[:, 1]) * (wins[:, 4] - wins[:, 2])).astype(np.float64)
    return ((counts - 1.0) / np.maximum(area, 1.0)).astype(np.float64)


def enrichment(index: SpatialIndex, radius_bins: int = 2) -> np.ndarray:
    """Per-object neighbourhood enrichment: the marked fraction in the
    window around each object (the object excluded) over the global
    marked fraction."""
    if index.mark_tables is None or index.mark is None:
        raise ValueError("enrichment needs a marked spatial index")
    counts, marked = index.neighborhood(radius_bins)
    n = np.maximum(counts - 1.0, 0.0)
    m = np.maximum(marked - index.mark, 0.0)
    local = np.where(n > 0, m / np.maximum(n, 1.0), 0.0)
    global_frac = index.n_marked / max(index.n_objects, 1.0)
    return (local / max(global_frac, 1e-9)).astype(np.float64)
