"""1-D smoothing of the needle-length series.

Counterpart of ``yolo_puncture_tpu/ops/signal.py``; the numpy functions are the
same arithmetic, so they agree with the JAX package's to the last bit:
  * ``gaussian_smoothing(lens, sigma=3)``: scipy ``gaussian_filter1d`` defaults
    (mode 'reflect', truncate 4.0);
  * ``savitzky_golay_smoothing(lens, 7, 2)``: scipy ``savgol_filter`` with its
    'interp' edges;
  * ``difference``: forward difference, re-interpolated to the input length;
  * ``median_smoothing``: edge-padded median filter.
``gaussian_smoothing_torch`` is the fp32 tensor form (the JAX package's
``gaussian_smoothing_jnp``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * x * x / (float(sigma) ** 2))
    return phi / phi.sum()


def gaussian_smoothing(lens, sigma: float = 3.0, truncate: float = 4.0):
    """Gaussian smoothing with scipy gaussian_filter1d('reflect') semantics.
    Accepts a list or ndarray; returns a Python list."""
    x = np.asarray(lens, dtype=np.float64)
    if x.size == 0:
        return []
    w = _gaussian_kernel(sigma, truncate)
    radius = (len(w) - 1) // 2
    xp = np.pad(x, radius, mode="symmetric")  # scipy 'reflect' == numpy 'symmetric'
    return np.convolve(xp, w[::-1], mode="valid").tolist()


def gaussian_smoothing_torch(x: torch.Tensor, sigma: float = 3.0, truncate: float = 4.0) -> torch.Tensor:
    """fp32 Gaussian smoothing of a 1-D tensor on its device ('reflect' edges,
    as ``gaussian_smoothing``), for a series that is already on the card."""
    x = x.to(torch.float32)
    n = x.shape[0]
    w = torch.from_numpy(_gaussian_kernel(sigma, truncate)).to(device=x.device, dtype=torch.float32)
    radius = (w.shape[0] - 1) // 2
    # numpy's 'symmetric' pad for any n (it repeats the mirror when radius > n)
    m = torch.remainder(torch.arange(-radius, n + radius, device=x.device), 2 * n)
    xp = x[torch.where(m < n, m, 2 * n - 1 - m)]
    return F.conv1d(xp[None, None], w.flip(0)[None, None])[0, 0]


def _savgol_coeffs(window: int, order: int) -> np.ndarray:
    half = window // 2
    pos = np.arange(-half, half + 1, dtype=np.float64)
    A = pos[:, None] ** np.arange(order + 1)[None, :]
    return np.linalg.pinv(A)[0]  # least-squares fit evaluated at the centre


def savitzky_golay_smoothing(lens, window_size: int = 7, poly_order: int = 2):
    """Savitzky-Golay with scipy savgol_filter mode='interp' edge handling."""
    x = np.asarray(lens, dtype=np.float64)
    n = x.size
    if n == 0:
        return []
    if n < window_size:
        raise ValueError("window_size is too large for the input")
    c = _savgol_coeffs(window_size, poly_order)
    half = window_size // 2
    out = np.empty(n, dtype=np.float64)
    out[half:n - half] = np.convolve(x, c[::-1], mode="valid")
    # 'interp': polynomial fit on the first/last window evaluated at the edge points
    p_head = np.polynomial.polynomial.polyfit(np.arange(window_size), x[:window_size], poly_order)
    out[:half] = np.polynomial.polynomial.polyval(np.arange(half), p_head)
    p_tail = np.polynomial.polynomial.polyfit(np.arange(window_size), x[n - window_size:], poly_order)
    out[n - half:] = np.polynomial.polynomial.polyval(np.arange(window_size - half, window_size), p_tail)
    return out.tolist()


def difference(lens):
    """Forward difference re-interpolated to the input length."""
    x = np.asarray(lens, dtype=np.float64)
    if x.size < 2:
        return np.zeros_like(x)
    diff = x[1:] - x[:-1]
    return np.interp(np.arange(x.size), np.arange(diff.size), diff)


def median_smoothing(lens, k: int = 7):
    """Median filter over k samples, edges padded with the end values."""
    x = np.asarray(lens, dtype=np.float64)
    if x.size == 0:
        return []
    half = k // 2
    xp = np.pad(x, half, mode="edge")
    return np.median(np.lib.stride_tricks.sliding_window_view(xp, k), axis=1).tolist()
