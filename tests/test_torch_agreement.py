"""``kernels/agreement.py``: the check that holds a fused kernel against its
plain version catches faults that leave the final x alone."""
import pytest
import torch

from rwm_pt_tpu_torch.kernels import agreement
from rwm_pt_tpu_torch.kernels.draws import seed_key
from rwm_pt_tpu_torch.kernels.fused_pt import _run_pt_fused_plain
from rwm_pt_tpu_torch.kernels.fused_rwm import _run_rwm_fused_plain
from rwm_pt_tpu_torch.targets import FullRosenbrock

torch.set_num_threads(1)
D, T, C = 5, 4, 48


def _pt(burn_in=6):
    g = torch.Generator().manual_seed(0)
    target = FullRosenbrock.create(D, device="cpu")
    betas = torch.logspace(0, -2, T)
    x0 = (0.5 * torch.randn(D, 1, C, generator=g)).expand(D, T, C)
    return _run_pt_fused_plain(
        target, x0.contiguous(), torch.zeros(T, C, dtype=torch.int32),
        torch.zeros(C, dtype=torch.int32), torch.zeros(C), torch.zeros(C),
        betas, torch.sqrt(0.1 / betas), seed_key(5), 0, 30, burn_in, 4)


def _rwm(burn_in=6):
    g = torch.Generator().manual_seed(1)
    target = FullRosenbrock.create(D, device="cpu")
    return _run_rwm_fused_plain(
        target, 0.5 * torch.randn(D, C, generator=g),
        torch.zeros(C, dtype=torch.int32), torch.zeros(C), torch.tensor(1.0),
        torch.tensor(0.2), seed_key(6), 0, 30, burn_in)


def test_identical_outputs_agree():
    for out, names in ((_pt(), agreement.PT_OUTPUTS),
                       (_rwm(), agreement.RWM_OUTPUTS)):
        a = agreement.hold(out, out, names)
        assert a.frac == 1.0 and a.max_dx == 0.0 and not a.mismatched
        assert set(a.max_rel) == {n for n, t in zip(names[1:], out[1:])
                                  if t.dtype.is_floating_point}


@pytest.mark.parametrize("run,names", [(_pt, agreement.PT_OUTPUTS),
                                       (_rwm, agreement.RWM_OUTPUTS)])
def test_burn_in_off_by_one_is_caught(run, names):
    """One more counted step leaves x as it was but moves the counters and
    the jump sums: the hold fails although every replica's x agrees."""
    good, bad = run(burn_in=6), run(burn_in=5)
    assert torch.equal(good[0], bad[0])
    a = agreement.hold(bad, good, names)
    assert a.frac == 1.0
    assert "acc" in a.mismatched


@pytest.mark.parametrize("field", ["lp", "swapacc", "betajump", "coldjump"])
def test_one_replica_fault_is_caught(field):
    out = list(_pt())
    i = agreement.PT_OUTPUTS.index(field)
    wrong = out[i].clone()
    if wrong.dtype.is_floating_point:
        wrong[..., 7] = wrong[..., 7] * (1 + 1e-3) + 1e-3
    else:
        wrong[..., 7] += 1
    bad = out[:i] + [wrong] + out[i + 1:]
    a = agreement.hold(bad, out, agreement.PT_OUTPUTS)
    assert a.mismatched == {field: 1}


def test_pre_sweep_snapshot_is_caught():
    """A PT trace entry is rung 0 after the swap sweep of its step.  Entries
    taken before the sweep fail the hold although x and every counter
    agree.  On a two-rung ladder they are rebuilt from a step-by-step run:
    rung 0 before the sweep is rung 1 after it where pair 0 swapped."""
    g = torch.Generator().manual_seed(2)
    target = FullRosenbrock.create(D, device="cpu")
    betas = torch.tensor([1.0, 0.3])
    x = (0.5 * torch.randn(D, 1, C, generator=g)).expand(D, 2, C)
    x = x.contiguous()

    def run(x0, step0, total, **kw):
        zi = torch.zeros(2, C, dtype=torch.int32)
        return _run_pt_fused_plain(
            target, x0, zi, zi[0], torch.zeros(C), torch.zeros(C), betas,
            torch.sqrt(0.1 / betas), seed_key(7), step0, total, 0, 2, **kw)

    steps = 12
    good = run(x, 0, steps, record_every=1, record_chains=C)
    pre, post = [], []
    for s in range(steps):
        out = run(x, s, 1)
        x = out[0]
        post.append(x[:, 0])
        pre.append(torch.where(out[3] > 0, x[:, 1], x[:, 0]))
    assert torch.equal(torch.stack(post), good[-1])
    bad = good[:-1] + (torch.stack(pre),)
    a = agreement.hold(bad, good, agreement.PT_REC_OUTPUTS)
    assert a.frac == 1.0
    assert set(a.mismatched) == {"chain"} and a.mismatched["chain"] > C // 4


def test_diverged_replica_is_left_out():
    """A replica whose x parted ways is counted out of the share and its
    other outputs are not compared."""
    out = list(_rwm())
    x, acc = out[0].clone(), out[2].clone()
    x[:, 3] += 0.5
    acc[3] += 4
    a = agreement.hold([x, out[1], acc, out[3]], out, agreement.RWM_OUTPUTS)
    assert a.frac == pytest.approx((C - 1) / C)
    assert not a.mismatched


@pytest.mark.parametrize("run,names", [(_pt, agreement.PT_OUTPUTS),
                                       (_rwm, agreement.RWM_OUTPUTS)])
def test_lp_held_against_the_kernels_own_x(run, names):
    """With ``lp_of`` the lp of every agreeing replica must be the
    target's log-density at the kernel's x: a stale lp on one replica (the
    value of its previous state) fails, while x moved by a few float32
    ulps, which moves a near-zero lp by more than RTOL of itself, does
    not."""
    target = FullRosenbrock.create(D, device="cpu")
    out = list(run())
    assert agreement.hold(out, out, names,
                          lp_of=target.log_density_td).mismatched == {}
    i = names.index("lp")
    stale = out[i].clone()
    stale[..., 3] = target.log_density_td(out[0][..., 3] + 0.01)
    bad = out[:i] + [stale] + out[i + 1:]
    a = agreement.hold(bad, out, names, lp_of=target.log_density_td)
    assert a.mismatched == {"lp": 1}
    nudged = out[0] * (1 + 2 ** -22)
    moved = [nudged] + out[1:i] + [target.log_density_td(nudged)] \
        + out[i + 1:]
    assert not agreement.hold(moved, out, names,
                              lp_of=target.log_density_td).mismatched
