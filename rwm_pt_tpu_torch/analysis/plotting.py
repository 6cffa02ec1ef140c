"""ESJD-against-acceptance plots of averaged sweep data (port of
``rwm_pt_tpu.analysis.plotting``): for every ``*_averaged.json`` in a data
directory, ESJD against the (swap) acceptance rate with lines at the
theoretical 0.234 and 0.135, saved under ``images/averaged/``.
matplotlib (``Agg``) is imported when a plot is made.

    python -m rwm_pt_tpu_torch.analysis.plotting --data_dir data
"""
from __future__ import annotations

import argparse
import json
import os


def _extract_dimension(filename: str):
    for part in filename.split("_"):
        if part.startswith("dim"):
            try:
                return int(part[3:])
            except ValueError:
                pass
    return None


def create_esjd_plot(data: dict, filename: str, images_dir: str = "images"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dim = _extract_dimension(filename)
    x_range = data["acceptance_rates"]
    if "swap_acceptance_rates_range" in data:
        x_range = data["swap_acceptance_rates_range"]
    plt.plot(x_range, data["expected_squared_jump_distances"], marker="x")
    plt.axvline(x=0.234, color="red", linestyle=":", label="a = 0.234")
    plt.axvline(x=0.135, color="purple", linestyle=":", label="a = 0.135")
    plt.xlabel("acceptance rate")
    plt.ylabel("ESJD")
    plt.title(f"ESJD vs acceptance rate (dim={dim})")
    plt.legend()
    plt.tight_layout()
    out_dir = os.path.join(images_dir, "averaged")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, os.path.splitext(filename)[0] + ".png")
    plt.savefig(out, dpi=150, bbox_inches="tight")
    plt.clf()
    plt.close()
    print(f"Plot created and saved as '{out}'")
    return out


def process_directory(directory_path: str = "data", images_dir: str = "images"):
    for filename in sorted(os.listdir(directory_path)):
        if filename.endswith("averaged.json"):
            path = os.path.join(directory_path, filename)
            try:
                with open(path) as f:
                    data = json.load(f)
                create_esjd_plot(data, filename, images_dir)
            except Exception as e:  # noqa: BLE001 - one bad file skips
                print(f"Error processing {filename}: {e}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Plot averaged ESJD curves")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--images_dir", type=str, default="images")
    args = parser.parse_args(argv)
    process_directory(args.data_dir, args.images_dir)


if __name__ == "__main__":
    main()
