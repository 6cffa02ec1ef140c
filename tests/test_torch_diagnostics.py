"""The port's copy of the convergence diagnostics
(rwm_pt_tpu_torch/analysis/diagnostics.py) against the JAX package's
module, bit for bit, on numpy chains of every accepted layout."""
import numpy as np
import pytest

from rwm_pt_tpu.analysis import diagnostics as jdiag
from rwm_pt_tpu_torch.analysis import diagnostics as tdiag

FUNCS = ["effective_sample_size", "split_rhat", "mcse_mean",
         "integrated_autocorr_time", "autocorrelation"]


def _chain(shape):
    """An AR(1) chain (autocorrelation 0.8) along axis 0, from a seed."""
    rng = np.random.default_rng(7)
    e = rng.normal(size=shape)
    x = np.empty(shape)
    x[0] = e[0]
    for t in range(1, shape[0]):
        x[t] = 0.8 * x[t - 1] + e[t]
    return x.astype(np.float32)


SHAPES = {"one-chain": (501,), "chains": (400, 6), "dim-chains": (301, 3, 4)}
# autocorrelation takes (n,) or (n, chains) draws only
CASES = [(fn, name) for fn in FUNCS for name in SHAPES
         if not (fn == "autocorrelation" and name == "dim-chains")]


@pytest.mark.parametrize("fn,shape", CASES,
                         ids=[f"{fn}-{name}" for fn, name in CASES])
def test_diagnostics_bit_equal(fn, shape):
    x = _chain(SHAPES[shape])
    np.testing.assert_array_equal(getattr(tdiag, fn)(x),
                                  getattr(jdiag, fn)(x))


def test_constant_chain_and_errors_match():
    """A stuck chain and too-short input behave as in the JAX module."""
    x = np.ones((50, 2))
    for fn in FUNCS:
        np.testing.assert_array_equal(getattr(tdiag, fn)(x),
                                      getattr(jdiag, fn)(x))
    for bad in (np.ones(3), np.ones((2, 2, 2, 2))):
        with pytest.raises(ValueError) as je:
            jdiag.split_rhat(bad)
        with pytest.raises(ValueError) as te:
            tdiag.split_rhat(bad)
        assert str(te.value) == str(je.value)
