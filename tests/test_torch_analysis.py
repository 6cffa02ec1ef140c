"""The port's post-processing tools (``rwm_pt_tpu_torch.analysis``:
``average_seeds``, ``batch_average_seeds``, ``combine_data``,
``plotting``) against the JAX package's on the same input files, made
from the committed reference curves (``data/ref_averaged/``): the same
JSON and the same file names."""
import json
import os
import shutil

import pytest

from rwm_pt_tpu import analysis as janalysis
from rwm_pt_tpu.analysis import average_seeds as javg
from rwm_pt_tpu.analysis import batch_average_seeds as jbatch
from rwm_pt_tpu.analysis import combine_data as jcomb
from rwm_pt_tpu.analysis import plotting as jplot
from rwm_pt_tpu_torch import analysis as tanalysis
from rwm_pt_tpu_torch.analysis import average_seeds as tavg
from rwm_pt_tpu_torch.analysis import batch_average_seeds as tbatch
from rwm_pt_tpu_torch.analysis import combine_data as tcomb
from rwm_pt_tpu_torch.analysis import plotting as tplot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "data", "ref_averaged")
RWM = "EvenRosenbrock_Normal_RWM_GPU_dim{}_1000000iters"
PT = "MultivariateNormal_PT_GPU_dim{}_500000iters"
# seed files of two configurations: committed curves of one grid each,
# renamed as the seeds of one sweep
GROUPS = {"MVN_Normal_RWM_GPU_dim7_100iters": (RWM, (2, 4, 10)),
          "MVN_PT_GPU_dim7_100iters": (PT, (10, 20))}


def _ref(fmt, d):
    return next(os.path.join(REF, f) for f in sorted(os.listdir(REF))
                if f.startswith(fmt.format(d) + "_"))


@pytest.fixture
def seed_dir(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for base, (fmt, dims) in GROUPS.items():
        for seed, d in enumerate(dims, start=1):
            shutil.copy(_ref(fmt, d), src / f"{base}_seed{seed}.json")
    return src


def _tree(path):
    return {f: (json.load(open(os.path.join(path, f)))
                if f.endswith(".json") else None)
            for f in sorted(os.listdir(path))}


def test_exports_match_jax():
    assert sorted(tanalysis.__all__) == sorted(janalysis.__all__)


@pytest.mark.parametrize("base", sorted(GROUPS))
def test_average_seeds_matches_jax(seed_dir, tmp_path, base):
    out = {}
    for name, mod in (("jax", javg), ("port", tavg)):
        out[name] = tmp_path / name
        mod.main(["--pattern", base, "--data_dir", str(seed_dir),
                  "--out_dir", str(out[name])])
    assert _tree(out["port"]) == _tree(out["jax"])
    (fname,) = os.listdir(out["port"])
    n = len(GROUPS[base][1])
    assert fname == f"{base}_seeds{'-'.join(map(str, range(1, n + 1)))}" \
        "_averaged.json"
    files = tavg.find_matching_files(str(seed_dir), base)
    assert files == javg.find_matching_files(str(seed_dir), base)
    assert tavg.average_experiment_data(files) == \
        javg.average_experiment_data(files)


def test_construct_pattern_matches_jax():
    for algo in ("RWM_GPU", "PT_GPU", "RWM_TPU"):
        assert tavg.construct_pattern("T", algo, 3, 10, "Laplace") == \
            javg.construct_pattern("T", algo, 3, 10, "Laplace")


def test_batch_average_matches_jax(seed_dir, tmp_path, capsys):
    out = {}
    for name, mod in (("jax", jbatch), ("port", tbatch)):
        out[name] = tmp_path / name
        shutil.copytree(seed_dir, out[name])
        mod.main(["--data_dir", str(out[name]), "--min_seeds", "2"])
    assert _tree(out["port"]) == _tree(out["jax"])
    assert "Averaged 2 configuration groups." in capsys.readouterr().out


def test_combine_data_matches_jax(seed_dir, tmp_path):
    files = sorted(str(p) for p in seed_dir.glob("*RWM*"))[:2]
    a, b = tmp_path / "jax.json", tmp_path / "port.json"
    jcomb.main(files + ["-o", str(a)])
    tcomb.main(files + ["-o", str(b)])
    assert json.loads(b.read_text()) == json.loads(a.read_text())
    with pytest.raises(SystemExit):
        tcomb.main(files[:1] + ["-o", str(b)])


def test_plotting_matches_jax(tmp_path):
    """Every ``*_averaged.json`` of a directory plotted to a PNG of the
    JAX tool's name under ``images/averaged``."""
    data = tmp_path / "data"
    data.mkdir()
    for fmt, d in ((RWM, 2), (PT, 10)):
        shutil.copy(_ref(fmt, d), data)
    names = {}
    for name, mod in (("jax", jplot), ("port", tplot)):
        mod.process_directory(str(data), str(tmp_path / name))
        names[name] = sorted(os.listdir(tmp_path / name / "averaged"))
    assert names["port"] == names["jax"] and len(names["port"]) == 2
    assert tplot._extract_dimension("X_RWM_GPU_dim17_5iters.json") == 17
