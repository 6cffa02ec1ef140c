"""Group and average every multi-seed configuration in a data directory
(port of ``rwm_pt_tpu.analysis.batch_average_seeds``): the seed files
grouped by their base pattern, every group of at least ``min_seeds``
members averaged by ``average_seeds``.

    python -m rwm_pt_tpu_torch.analysis.batch_average_seeds --data_dir data
"""
from __future__ import annotations

import argparse
import os
import re
from collections import defaultdict

from .average_seeds import (average_experiment_data, generate_output_filename,
                            save_json)

_SEED_RE = re.compile(r"^(?P<base>.+)_seed(?P<seed>\d+)\.json$")


def group_seed_files(data_dir: str):
    groups = defaultdict(list)
    for fn in sorted(os.listdir(data_dir)):
        if fn.endswith("_averaged.json") or not fn.endswith(".json"):
            continue
        m = _SEED_RE.match(fn)
        if m:
            groups[m.group("base")].append(os.path.join(data_dir, fn))
    return groups


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Batch-average all multi-seed configurations")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--min_seeds", type=int, default=2)
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)

    groups = group_seed_files(args.data_dir)
    n_done = 0
    for base, files in sorted(groups.items()):
        if len(files) < args.min_seeds:
            continue
        print(f"{base}: {len(files)} seeds")
        if args.dry_run:
            continue
        try:
            data = average_experiment_data(files)
        except ValueError as e:
            print(f"  skipped: {e}")
            continue
        out = os.path.join(args.data_dir, generate_output_filename(
            base, data["averaged_from_seeds"]))
        save_json(data, out)
        print(f"  -> {os.path.basename(out)}")
        n_done += 1
    print(f"Averaged {n_done} configuration groups.")


if __name__ == "__main__":
    main()
