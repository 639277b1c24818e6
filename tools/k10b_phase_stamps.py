"""Phase split of K10b pgo_eliminate on the card, from clock64 stamps.

Copies csrc/ of a source tree (this checkout's lidar_odometry_tpu_torch/,
or --src DIR, for example an older commit unpacked with `git archive` into
a directory that .gitignore lists) into build/k10b_stamps/<tag>/ with a
stamp (tools/phase_stamps.py) before every phase comment ("// ---- name")
of eliminate_kernel, one at its start and one before its closing brace,
taken in the block of the partition with the most valid rows.

It builds that copy with the port's nvcc flags (and prints ptxas's report
of eliminate_kernel), runs it through the tree's own wrapper on
chip_smoke.py's PGO-path input (the KITTI-00-sized graph, its first
Gauss-Newton iteration's blocks), checks the result against the plain
twin (1e-10 of each output's largest magnitude), and prints the launch's
device time from CUDA events (30 launches queued behind a spin, so that
the host's cost of issuing them is hidden) and each phase's cycles, share
and cycles a stamp of one launch.

    python tools/k10b_phase_stamps.py [--src DIR] [--plain]

With --plain the copy has no stamps: it prints the launch's device time
alone, the time the stamps do not perturb, on any tree (an older kernel
included).

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import phase_stamps as ps  # noqa: E402

ROOT = ps.ROOT


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=None,
                    help="a tree holding lidar_odometry_tpu_torch/ (default: this checkout)")
    ap.add_argument("--plain", action="store_true", help="no stamps: the device time alone")
    args = ap.parse_args()
    tree = (args.src or ROOT).resolve()
    tag = "checkout" if args.src is None else tree.name
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree))     # the tree's package and its own wrapper
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k10b_phase_stamps: needs a CUDA device")
    import chip_smoke as cs
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {kernels.__file__}, not the package under {tree}")

    init, priors, betweens, _ = cs.make_pgo_graph()
    pk = dpgo.pack_graph(init, priors, betweens)
    rows = pk.i32["valid"].sum(1)
    block = int(np.argmax(rows))
    g = dpgo.upload(pk, "cuda")
    diag, off, b, _ = dpgo.linearize_plain(g["poses"], *[g[k] for k in dpgo.LIN_KEYS])
    out = ROOT / "build" / "k10b_stamps" / (tag + ("_plain" if args.plain else ""))
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    stamps = ps.Stamps()
    texts = {} if args.plain else {"pgo.cu": stamps.function(
        (csrc / "pgo.cu").read_text().splitlines(), r"^eliminate_kernel\(",
        first="prologue: loop state", last="end")}
    ps.copy_sources(csrc, out, "pgo", texts)
    lib = ps.build(out, "pgo", out / "libpgo_stamped.so", block, "eliminate_kernel")
    k = kernels.KERNELS["pgo_eliminate"]
    fn = lib.lo_pgo_eliminate
    fn.argtypes = k.argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k._fn = fn          # the tree's wrapper now launches the stamped copy

    got = dpgo.eliminate(g, diag, off, b)
    ref = dpgo.eliminate_plain(diag, off, b, *[g[key] for key in dpgo.PLAN_KEYS])
    err = max(float((a - c).abs().max() / c.abs().max()) for a, c in zip(got, ref))
    if not err <= 1e-10:
        raise SystemExit(f"the stamped kernel differs from the twin: {err:.3e}")
    if not all(torch.equal(a, c) for a, c in zip(got, dpgo.eliminate(g, diag, off, b))):
        raise SystemExit("two calls differ")
    ms = cs.device_ms(lambda: dpgo.eliminate(g, diag, off, b), 30)
    card = ps.card()
    D, max_m = pk.D, pk.max_m
    if args.plain:
        print(f"K10b ({tag}, no stamps; {card}): D = {D}, max_m = {max_m}, {ms:.4f} ms a launch "
              f"on the device (CUDA events, 30 launches), {err:.2e} of the largest magnitude "
              f"from the twin, two calls bit-equal")
        return
    ps.clear(lib)
    dpgo.eliminate(g, diag, off, b)
    torch.cuda.synchronize()
    phases, total, n = ps.split(lib, stamps.labels)
    print(f"K10b phase split ({tag}; {card}): D = {D}, max_m = {max_m}, partition {block} "
          f"with {int(rows[block])} valid rows stamped; {total} cycles stamped "
          f"({total / max_m:.0f} a row of max_m, {n} stamps), {ms:.4f} ms a launch on the "
          f"device (CUDA events, 30 launches), {err:.2e} of the largest magnitude from the twin")
    ps.report(phases, total)


if __name__ == "__main__":
    main()
