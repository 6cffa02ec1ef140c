"""Average MCMC sweep results across seeds (port of
``rwm_pt_tpu.analysis.average_seeds``, numpy and json only).

Finds the JSON sweep files of one experimental configuration that differ
only in seed, averages their ESJD and acceptance arrays and scalar optima
element-wise, and writes a ``*_averaged.json`` with provenance metadata,
for the RWM and the PT sweep schemas alike: the JAX tool's file names and
keys, so either package's sweeps (``_RWM_GPU_``, ``_RWM_TPU_``) average
the same way.

    python -m rwm_pt_tpu_torch.analysis.average_seeds \
        --pattern MultivariateNormal_Normal_RWM_GPU_dim20_100000iters \
        --data_dir data
"""
from __future__ import annotations

import argparse
import json
import os
import re
from typing import Any, Dict, List

import numpy as np


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def save_json(data: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def find_matching_files(data_dir: str, pattern: str) -> List[str]:
    """Files matching ``{pattern}_seed<N>.json`` or ``{pattern}.json``."""
    seed_re = re.compile(rf"{re.escape(pattern)}_seed\d+\.json$")
    plain_re = re.compile(rf"{re.escape(pattern)}\.json$")
    out = []
    for fn in os.listdir(data_dir):
        if fn.endswith(".json") and (seed_re.match(fn) or plain_re.match(fn)):
            out.append(os.path.join(data_dir, fn))
    return sorted(out)


_ARRAY_FIELDS = ["expected_squared_jump_distances", "acceptance_rates",
                 "swap_acceptance_rates_range", "times"]
_SCALAR_FIELDS = ["max_esjd", "max_acceptance_rate", "max_scale_param",
                  "max_actual_acceptance_rate", "max_constr_acceptance_rate",
                  "max_variance_value", "total_time"]
_REFERENCE_FIELDS = ["scale_param_range", "var_value_range",
                     "target_distribution", "proposal_distribution",
                     "dimension", "num_iterations", "num_chains", "backend"]


def average_experiment_data(file_paths: List[str]) -> Dict[str, Any]:
    """Element-wise mean of arrays and scalars, with provenance: the
    seeds, the count and the names of the source files; a field whose
    arrays differ in length raises ``ValueError``."""
    if not file_paths:
        raise ValueError("No files provided for averaging")
    all_data = [load_json(p) for p in file_paths]
    seeds = []
    for p in file_paths:
        m = re.search(r"seed(\d+)", os.path.basename(p))
        seeds.append(int(m.group(1)) if m else None)

    # the grids must be of one length
    for field in _ARRAY_FIELDS + ["scale_param_range"]:
        lengths = {p: len(d[field]) for p, d in zip(file_paths, all_data)
                   if isinstance(d.get(field), list)}
        if lengths and len(set(lengths.values())) > 1:
            msg = f"Inconsistent array lengths for field '{field}':\n" + "".join(
                f"  - {os.path.basename(p)}: length {n}\n"
                for p, n in sorted(lengths.items()))
            raise ValueError(msg)

    ref = all_data[0]
    out: Dict[str, Any] = {}
    for field in _SCALAR_FIELDS:
        vals = [d[field] for d in all_data if field in d]
        if vals:
            out[field] = float(np.mean(vals))
    for field in _ARRAY_FIELDS:
        arrs = [d[field] for d in all_data if field in d]
        if arrs:
            stacked = np.stack([np.asarray(a) for a in arrs])
            out[field] = np.mean(stacked, axis=0).tolist()
            # across-seed spread (1 sd) — quantifies the single-seed noise of
            # the source files, used by the parity analysis to decide whether
            # a curve delta is reference-side noise or a semantics bug
            if field in ("expected_squared_jump_distances",
                         "acceptance_rates") and len(arrs) > 1:
                out[field + "_seed_std"] = np.std(
                    stacked, axis=0, ddof=1).tolist()
    # the swap rate at the largest ESJD
    if ("expected_squared_jump_distances" in ref
            and "swap_acceptance_rates_range" in ref):
        at_max = []
        for d in all_data:
            esjds = d.get("expected_squared_jump_distances")
            rates = d.get("swap_acceptance_rates_range")
            if esjds and rates and len(esjds) == len(rates):
                at_max.append(rates[int(np.argmax(esjds))])
        if at_max:
            out["max_swap_acceptance_rate"] = float(np.mean(at_max))
    for field in _REFERENCE_FIELDS:
        if field in ref:
            out[field] = ref[field]
    out["averaged_from_seeds"] = [s for s in seeds if s is not None]
    out["num_files_averaged"] = len(file_paths)
    out["source_files"] = [os.path.basename(p) for p in file_paths]
    return out


def generate_output_filename(pattern: str, seeds: List[int]) -> str:
    """``{pattern}_seeds{a-b-..}_averaged.json``."""
    seed_str = (f"seeds{'-'.join(map(str, sorted(seeds)))}" if seeds
                else "averaged")
    return f"{pattern}_{seed_str}_averaged.json"


def construct_pattern(target: str, algorithm: str, dim: int, iters: int,
                      proposal: str = "Normal") -> str:
    """RWM files carry a proposal segment ('{target}_{proposal}_RWM_GPU_...',
    cli/experiment_rwm.py); PT files do not ('{target}_PT_GPU_...')."""
    if algorithm.upper().startswith("PT"):
        return f"{target}_{algorithm}_dim{dim}_{iters}iters"
    return f"{target}_{proposal}_{algorithm}_dim{dim}_{iters}iters"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Average MCMC experimental results across random seeds")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--pattern", type=str,
                       help='e.g. "MultivariateNormal_Normal_RWM_GPU_dim20_'
                            '100000iters"')
    group.add_argument("--target", type=str)
    parser.add_argument("--algorithm", type=str, default="RWM_GPU")
    parser.add_argument("--proposal", type=str, default="Normal",
                        help="Proposal segment of RWM filenames (ignored "
                             "for PT)")
    parser.add_argument("--dim", type=int)
    parser.add_argument("--iters", type=int)
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--out_dir", type=str, default=None,
                        help="Write the averaged JSON here instead of "
                             "data_dir (data_dir may be read-only, e.g. "
                             "committed results)")
    parser.add_argument("--min_seeds", type=int, default=2)
    args = parser.parse_args(argv)

    pattern = args.pattern or construct_pattern(args.target, args.algorithm,
                                                args.dim, args.iters,
                                                args.proposal)
    files = find_matching_files(args.data_dir, pattern)
    if len(files) < args.min_seeds:
        raise SystemExit(f"Found only {len(files)} files for pattern "
                         f"'{pattern}' (need >= {args.min_seeds})")
    print(f"Averaging {len(files)} files:")
    for f in files:
        print(f"  {os.path.basename(f)}")
    data = average_experiment_data(files)
    out_name = generate_output_filename(pattern, data["averaged_from_seeds"])
    out_dir = args.out_dir or args.data_dir
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, out_name)
    save_json(data, out_path)
    print(f"Averaged data written to {out_path}")


if __name__ == "__main__":
    main()
