"""The legacy combiner (port of ``rwm_pt_tpu.analysis.combine_data``):
the element-wise average of an explicit list of experiment files.
``average_seeds`` supersedes it (pattern matching, validation,
provenance); it stays for the legacy tool's users:

    python -m rwm_pt_tpu_torch.analysis.combine_data a.json b.json \
        -o combined.json
"""
import argparse

from .average_seeds import average_experiment_data, save_json


def combine_json(files, output_file):
    combined = average_experiment_data(list(files))
    save_json(combined, output_file)
    print(f"Combined {len(files)} files -> {output_file}")
    return combined


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Combine (element-wise average) experiment JSON files")
    p.add_argument("files", nargs="+", help="Input JSON files (>= 2)")
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)
    if len(args.files) < 2:
        raise SystemExit("Need at least two input files")
    combine_json(args.files, args.output)


if __name__ == "__main__":
    main()
