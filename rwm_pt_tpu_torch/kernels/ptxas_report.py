"""Registers, stack frame and spills of the fused kernels' libraries, as
ptxas reports them, for every target kind, register bucket and warp
bucket:

    python -m rwm_pt_tpu_torch.kernels.ptxas_report [variant ...]

(default: the Normal variants of both kernels with the two draws the
rule picks, ``fused_pt``, ``fused_rwm``, ``fused_pt_bm`` and
``fused_rwm_bm``; name any other variant, such as
``fused_pt_icdf_fastlog``, to report it).  Builds each library
that is not built yet (one ``nvcc`` each, all at once; needs the CUDA
toolkit) and prints one line per (variant, kind) with the bucket's
registers, stack frame and spill bytes (PT: the instantiation with 32
replicas a block, then the one that reads R at run time), and the build
seconds.
"""
from __future__ import annotations

import re
import sys
import time

from . import _build


def parse(log: str) -> list[tuple[str, int, int, int]]:
    """``(instantiation, registers, stack frame bytes, spill bytes)`` of
    each entry function in a ptxas ``-v`` report; a fused kernel's
    instantiation is named by its register bucket and, for PT, ``R32``
    (32 replicas a block) or ``Rrt`` (R read at run time), a warp kernel's
    by its warp bucket and team size (``W128 G4``: teams of 4 lanes), a
    probe kernel
    by its name and template argument (``draw_normals_kernel<2>``: the
    draw's ``_build.DRAWS`` code)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            # the kernel's own template arguments (a parameter's type, such
            # as a fixed SuperFunnel dataset, has its own)
            args = re.search(r"_kernelI((?:Li-?\d+E)+)E", m.group(1))
            t = re.findall(r"Li(-?\d+)E", args.group(1) if args else "")
            k = re.search(r"\d+([A-Za-z_]+_kernel)", m.group(1))
            name = (f"W{t[1]} G{t[2]}" if "warp_kernel" in m.group(1)
                    else f"D{t[1]}" if len(t) > 1 else
                    k.group(1) + "".join(f"<{a}>" for a in t) if k else
                    m.group(1))
            if len(t) > 2 and "warp_kernel" not in m.group(1):
                name += " R32" if t[2] != "0" else " Rrt"
            out.append([name, None, 0, 0])
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and out:
            out[-1][2] = int(m.group(1))
            out[-1][3] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1][1] is None:
            out[-1][1] = int(m.group(1))
    return [tuple(e) for e in out]


def report(variants) -> list[str]:
    def libs(v, k):
        return ([_build.lib_name(v, k, b) for b in _build.BUCKETS]
                + [_build.lib_name(v, k, b - 4) for b in _build.WARP_BUCKETS])
    names = [n for v in variants for k in _build.TARGET_KINDS
             for n in libs(v, k)]
    t0 = time.time()
    logs = _build.build(names)
    lines = [f"{len(names)} libraries in {time.time() - t0:.1f} s"]
    for v in variants:
        for k in _build.TARGET_KINDS:
            cells = [f"{n} {r}r {f}sf {sp}sp" for name in libs(v, k)
                     for n, r, f, sp in sorted(parse(logs[name]))]
            lines.append(f"{v}.{k}: " + ", ".join(cells))
    return lines


DEFAULT_VARIANTS = [_build.library(src, "Normal", draw)
                    for draw in ("icdf", "bm")
                    for src in ("fused_pt", "fused_rwm")]

if __name__ == "__main__":
    for line in report(sys.argv[1:] or DEFAULT_VARIANTS):
        print(line, flush=True)
