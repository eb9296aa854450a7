"""Diagnostic plots of a clip's lengths: ``plot_speeds``, the counterpart of
``yolo_puncture_tpu/utils/plotting.py``: four panels (the Gaussian-smoothed
shaft length and its first difference, whole and around the key frames) with
the predicted and the actual key frames marked.  matplotlib is imported when a
plot is drawn."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from yolo_puncture_tpu_torch.ops.signal import difference, gaussian_smoothing


def plot_speeds(lens, pred_range: Tuple[int, int], *, act_range: Optional[Tuple[int, int]] = None,
                file_path: Optional[str] = None, frame_bias: int = 20):
    import matplotlib

    if file_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    predict_start, predict_end = pred_range
    actual_start, actual_end = (-1, -1) if act_range is None else act_range

    def plot_sub(ax, array, start=0, end=-1, title="", x_label="Frame", y_label="Length"):
        x_values = np.arange(0, len(lens))
        ax.plot(x_values[start:end], np.asarray(array)[start:end])
        if actual_start >= 0 and actual_end >= 0:
            ax.axvline(x=actual_start, color="b", linestyle="--", alpha=0.5)
            ax.axvline(x=actual_end, color="b", linestyle="--", alpha=0.5)
            ax.plot([], [], color="b", linestyle="--", label="Actual")
        ax.axvline(x=predict_start, color="g", linestyle="solid", alpha=0.5)
        if predict_end is not None:
            ax.axvline(x=predict_end, color="g", linestyle="solid", alpha=0.5)
        ax.plot([], [], color="g", linestyle="solid", label="Predict")
        ax.set_xlabel(x_label)
        ax.set_ylabel(y_label)
        ax.set_title(title)
        ax.legend()

    start_idx = max(0, (min(predict_start, actual_start) - frame_bias))
    end_idx = min(len(lens), max(predict_start, actual_end if actual_end else 0) + frame_bias + 1)
    fig, ((ax1, ax2), (ax3, ax4)) = plt.subplots(2, 2, figsize=(12, 8))
    smooth_lens = gaussian_smoothing(lens)
    deriv = difference(smooth_lens)
    plot_sub(ax1, smooth_lens, title="Shaft Pixel Length (Gaussian Smooth)")
    plot_sub(ax2, smooth_lens, start_idx, end_idx, title="Shaft Pixel Length (Gaussian Smooth Range)")
    plot_sub(ax3, deriv, title="First Derivative", y_label="Value")
    plot_sub(ax4, deriv, start_idx, end_idx, title="First Derivative Range", y_label="Value")
    plt.tight_layout()
    if file_path is None:
        plt.show()
    else:
        plt.savefig(file_path)
    plt.close()
