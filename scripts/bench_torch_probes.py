"""Time the port's two probe kernels (``kernels/draw_probes.py``:
``draw_normals`` and ``fast_log``) beside the one PyTorch call that
computes the same function, device time and host time apart.

    python scripts/bench_torch_probes.py [--tree DIR] [--out FILE]

``--tree`` is a checkout of this repository whose ``rwm_pt_tpu_torch`` is
imported (default: the one holding this script): a variant of the probe
kernels with this tree's wrapper interface (``out=``,
``draw_probes._device``), unpacked beside it, is timed through its own
kernels and this checkout's phase 14a functions of ``chip_smoke.py``, so
run the trees one after another in one call to compare them on one card.
Builds ``draw_probes``, prints its ptxas report, holds every probe
against its plain version (``chip_smoke.hold_probes``, phase 14a's
holds), then at the test shapes and the bandwidth shape prints and writes
as JSON to ``--out``: (a) device us a launch (100 launches in one CUDA
graph), (b) host us a call (1000 calls on a host clock) and (c) the
single-call event time, each beside the library call's and the bound,
and the launch path's host work piece by piece.  Needs the card and
``nvcc``.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from rwm_pt_tpu_torch.kernels import (_build, draw_probes, draws,
                                          ptxas_report)

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cs.say(f"tree {os.path.abspath(a.tree)}; card {card}; torch "
           f"{torch.__version__} cuda {torch.version.cuda}")
    log = _build.build([_build.PROBES])[_build.PROBES]
    frames = [f"{n}: {f} B stack, {sp} B spill"
              for n, _, f, sp in ptxas_report.parse(log) if f or sp]
    cs.say("build draw_probes: " + "; ".join(
        f"{n} {r} regs, {f} B stack, {sp} B spill"
        for n, r, f, sp in sorted(ptxas_report.parse(log))))
    if frames:
        cs.fail(f"draw_probes has a stack frame or spills: {frames}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    seed = 12345
    yt, ybw = cs.probe_inputs(torch, dev, gen)
    held = cs.hold_probes(torch, dev, seed, gen, yt, ybw, phase="bench")
    res = {"tree": os.path.abspath(a.tree), "card": card,
           "holds": {"{}.{}".format(*k): v for k, v in held.items()},
           "timings": {}}
    torch.cuda.synchronize()
    for n, yy, label in ((cs.PROBE_N, yt, "test shape"),
                         (cs.PROBE_BW_N, ybw[:cs.PROBE_BW_N],
                          "bandwidth shape")):
        res["timings"][label] = cs.probe_timings(
            torch, draw_probes, draws, dev, seed, n, yy, label, phase="bench")
    res["host_breakdown"] = cs.host_breakdown(
        torch, draw_probes, dev, seed, cs.PROBE_N, yt, phase="bench")
    cs.say(f"card {card}")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
