"""Offline speed statistics: the port's ``apps/speed_freq.py``.

    python -m yolo_puncture_tpu_torch.apps.speed_freq [--input DIR] [--output DIR] [--fps F]

Reads each ``{lens, key_frame}`` pickle of ``--input``, takes the pixel→mm ratio
from the frames before the insertion (outliers by their median absolute
deviation removed), the speeds between pairs of frames around the key frames,
and writes ``<output>/<name>.png``: the speed histogram beside the length in mm
over the frames (matplotlib, imported when a file is drawn).  It needs no device.
"""

from __future__ import annotations

import argparse
import os
import pickle

from yolo_puncture_tpu_torch.analytics.stats import calculate_speed_mm, compute_pixel_to_mm_ratio


def process_pickle(filepath: str, output_dir: str, fps: float = 30.0) -> bool:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    base = os.path.splitext(os.path.basename(filepath))[0]
    with open(filepath, "rb") as f:
        data = pickle.load(f)
    lens_pixels = data["lens"]
    insert_start_frame, insert_spec_end_frame = data["key_frame"]
    if insert_start_frame is None or insert_spec_end_frame is None:
        return False
    try:
        if insert_start_frame == 0:
            # no frame before the insertion: the ratio stored under key 0, if any
            if 0 not in data:
                print(f"{base}: key_frame 0 and no stored ratio — skipped")
                return False
            pixel_to_mm = data[0]
        else:
            pixel_to_mm = compute_pixel_to_mm_ratio(lens_pixels, insert_start_frame)
        lens_mm = [length * pixel_to_mm for length in lens_pixels]
        speeds = calculate_speed_mm(lens_mm, insert_start_frame, insert_spec_end_frame, fps)

        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(18, 8))
        counts, bins, _ = ax1.hist(speeds, bins=30, color="blue", alpha=0.7)
        if counts.size > 0:
            mi = counts.argmax()
            ax1.text(0.98, 0.98,
                     f"Key Frame: {insert_start_frame}~{insert_spec_end_frame}\n"
                     f"Speed: {bins[mi]:.2f}~{bins[mi + 1]:.2f} mm/s",
                     transform=ax1.transAxes, fontsize=12, verticalalignment="top", horizontalalignment="right")
        ax1.set_title(f"Speed Histogram (Frames {insert_start_frame} - {insert_spec_end_frame}"
                      f" / Total {len(lens_mm)})")
        ax1.set_xlabel("Speed (mm/s)")
        ax1.set_ylabel("Frequency")
        ax1.grid(True)

        ax2.plot(lens_mm, color="green")
        ax2.axvline(x=insert_start_frame, color="b", linestyle="--", label="Insert Start Frame")
        ax2.axvline(x=insert_spec_end_frame, color="b", linestyle="--", label="Insert End Frame")
        ax2.set_title("Needle Length Over Frames (mm)")
        ax2.set_xlabel("Frame Number")
        ax2.set_ylabel("Length (mm)")
        ax2.legend()
        ax2.grid(True)

        os.makedirs(output_dir, exist_ok=True)
        out_path = os.path.join(output_dir, f"{base}.png")
        plt.savefig(out_path)
        plt.close()
        print(f"saved histogram to {out_path}")
        return True
    except ValueError as ve:
        print(f"Error processing {filepath}: {ve}")
        return False


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", default="resources/needle_lens", help="directory of {lens, key_frame} .pkl files")
    parser.add_argument("--output", default="resources/histograms")
    parser.add_argument("--fps", type=float, default=30.0)
    args = parser.parse_args(argv)
    for filename in os.listdir(args.input):
        if filename.endswith(".pkl"):
            process_pickle(os.path.join(args.input, filename), args.output, args.fps)


if __name__ == "__main__":
    main()
