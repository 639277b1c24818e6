"""Device times of K12a pgo_block_thomas and K12b pgo_eliminate_lu, and
their phase splits, on the card, at the Schur path's shapes, from CUDA
events and clock64 stamps.

Inputs (made once on the card by --make-inputs with this checkout's
package and kept in --inputs, so that every tree of one call runs on the
same tensors): the first Gauss-Newton system of the Schur path's
KITTI-00-sized graph (chip_smoke.make_pgo_graph: 3700 keyframes, 32 loop
edges) as PoseGraphOptimizer._linearize_distributed builds it; K12a gets
its block-tridiagonal part (diag, off[:n-1], b: the loop couplings
dropped), K12b pack_interiors' packing of the whole system over
chip_smoke.schur_path's separators (D = 72 partitions, max_m = 211), each
in float64 and in float32.

Each call is compared with the tree's plain twin on the card (float64
within 1e-10 of the twin's largest magnitude, float32 within 1e-5; K12b
each of S, r, F, G, g) and against a second call (bit-equal), and timed
on the device (CUDA events over 30 calls queued behind a ~25 ms spin,
chip_smoke.device_ms) and as issued (chip_smoke.time_ms), with the device
records (kernels, memcpy, memset) of one call. Every tree's outputs of
one call are kept in build/k12_outputs_<tag>.pt; where another tree's
file is there, they are compared with its bit for bit.

Then, unless --plain, a tree whose kernels carry phase comments ("//
---- name") has both copied into build/k12_stamps/<tag>/ with a stamp
(tools/phase_stamps.py) before every phase comment, one at the start and
one before the closing brace: K12a read from thread 0 of block 0 (the
warp of partition 0, which then solves the separators' system), K12b
from thread 0 of the block of the partition with the most valid rows
(the one that sets the launch's time), also within a row (its inlined
chain_forward and chain_backward stamped at FORWARD_ANCHORS and
BACKWARD_ANCHORS); each forward and backward phase is also given per
row. An older tree's kernels are timed
only. A call out of tolerance or not bit-equal is printed, the runs go
on, and the tool exits 1 at the end.

    python tools/k12_phase_stamps.py --make-inputs
    python tools/k12_phase_stamps.py [--src DIR] [--plain] [--inputs FILE]

--src DIR: a tree holding lidar_odometry_tpu_torch/ (for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists); default this checkout. ptxas's registers and stack of both
kernels are printed from the tree's build.

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import phase_stamps as ps  # noqa: E402

ROOT = ps.ROOT
ENTRIES = (("schur", "block_thomas_kernel"), ("schur", "eliminate_lu_kernel"))
DTYPES = ("float64", "float32")
FAULTS: list = []   # calls out of tolerance or not bit-equal: the tool exits 1 after its runs
# K12b's forward and backward chains (chain_forward and chain_backward,
# each inlined once in its kernel) stamped within a row at these lines
FORWARD_ANCHORS = ((r"T cp\[6\], a\[6\], inval\[6\], L\[36\];", "fwd: row start"),
                   (r"if \(is_u\) \{   // L_\{r\+1\}", "fwd: Dt formed"),
                   (r"if \(r \+ 1 < m\) v = src.load", "fwd: L staged"),
                   (r"if \(vr\) \{", "fwd: next row's loads issued"),
                   (r"if \(stores\) \{", "fwd: LU solved"))
BACKWARD_ANCHORS = ((r"T nw\[6\];", "bwd: row start"),
                    (r"if \(r - 1 >= r0\) load\(r - 1\);", "bwd: row formed"),
                    (r"__syncwarp\(\);", "bwd: next row's loads issued"),
                    (r"out\(r, s\);", "bwd: synced"))


def make_inputs(path: Path) -> None:
    """The Schur path's K12a and K12b inputs in both dtypes, made on the
    card with this checkout's package; saved to `path`."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    graph = cs.make_pgo_graph()
    pg = cs.import_graph(graph)
    n = len(graph[0])
    diag, off, b, loops, _ = pg._linearize_distributed(n)
    seps = dpgo.plan_partition(n, min(pg.n_blocks, max(n // 2, 1)), loops)
    packed = dpgo.pack_interiors(diag, off, b, seps)
    out = {}
    for name in DTYPES:
        dt = getattr(torch, name)
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)
        out[name] = dict(chain=[to(a) for a in (diag, off[: n - 1], b)],
                         packed=[to(a) for a in packed[:-1]]
                         + [torch.from_numpy(packed[-1]).to("cuda")])
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)
    print(f"inputs: n {n}, {len(loops)} loop edges, D {len(seps)} partitions, max_m "
          f"{packed[0].shape[1]}, {int(packed[-1].sum())} valid rows; saved to {path}",
          flush=True)


def _rel(a, c) -> float:
    return float((a - c).abs().max() / c.abs().max().clamp(min=1e-300))


def timings(tag: str, card: str, inp) -> dict:
    """Both kernels in both dtypes against their twins and a second call,
    their device and as-issued times; the outputs kept."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    keep = {}
    for name in DTYPES:
        tol = 1e-10 if name == "float64" else 1e-5
        chain, packed = inp[name]["chain"], inp[name]["packed"]
        x = dpgo.block_tridiag_solve(*chain)
        err = _rel(x, dpgo.block_tridiag_solve_plain(*chain))
        same = torch.equal(x, dpgo.block_tridiag_solve(*chain))
        if not (err <= tol and same):
            FAULTS.append(f"K12a {name}: {err:.3e} of max|x| from its twin (tol {tol:.0e}), "
                          f"two calls equal {same}")
            print(f"  FAULT ({tag}): {FAULTS[-1]}", flush=True)
        keep[f"K12a x {name}"] = x
        call = lambda: dpgo.block_tridiag_solve(*chain)
        print(f"  K12a ({tag}; {card}): {name}, n {chain[0].shape[0]}: "
              f"{cs.device_ms(call, 30):.4f} ms on the device ({cs.time_ms(call, 30):.4f} as "
              f"issued), {ps.device_records(call)} device records a call; {err:.1e} of max|x| "
              f"from its twin", flush=True)
        outs = dpgo.eliminate_interior_lu(*packed)
        errs = [_rel(a, c) for a, c in zip(outs, dpgo.eliminate_interior_lu_plain(*packed))]
        same = all(torch.equal(a, c) for a, c in zip(outs, dpgo.eliminate_interior_lu(*packed)))
        if not (max(errs) <= tol and same):
            FAULTS.append(f"K12b {name}: S, r, F, G, g {errs} from the twin (tol {tol:.0e}), "
                          f"two calls equal {same}")
            print(f"  FAULT ({tag}): {FAULTS[-1]}", flush=True)
        for k, t in zip("S r F G g".split(), outs):
            keep[f"K12b {k} {name}"] = t
        call = lambda: dpgo.eliminate_interior_lu(*packed)
        D, m = packed[0].shape[:2]
        print(f"  K12b ({tag}; {card}): {name}, D {D}, max_m {m}: {cs.device_ms(call, 30):.4f} "
              f"ms on the device ({cs.time_ms(call, 30):.4f} as issued), "
              f"{ps.device_records(call)} device records a call; S, r, F, G, g "
              f"{', '.join(f'{e:.1e}' for e in errs)} of their largest from the twin", flush=True)
    return keep


def _per_row(phases: dict, rows: dict, us_per_cycle: float) -> None:
    for label, n in rows.items():
        if label in phases and n:
            cyc = phases[label][0]
            print(f"  {label}: {n} rows, {cyc / n:.0f} cycles ({cyc / n * us_per_cycle:.3f} us) "
                  f"a row", flush=True)


def stamps(tree: Path, tag: str, card: str, inp) -> None:
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    if "// ---- interior forward" not in (csrc / "schur.cu").read_text():
        print(f"no stamps ({tag}): its K12a has no phase comments", flush=True)
        return
    us_per_cycle = ps.sm_us_per_cycle()
    base = ROOT / "build" / "k12_stamps" / tag
    lib, labels = ps.stamped(tree, base / "k12a", "schur", [
        ("schur.cu", r"^block_thomas_kernel\(", "start", "end", ())], 0, "block_thomas_kernel",
        ["pgo_block_thomas"])
    for name in DTYPES:
        chain = inp[name]["chain"]
        n = chain[0].shape[0]
        P = dpgo.thomas_partitions(n)
        call = lambda: dpgo.block_tridiag_solve(*chain)
        ms = cs.device_ms(call, 30)
        ps.clear(lib)
        call()
        torch.cuda.synchronize()
        phases, total, n_st = ps.split(lib, labels)
        print(f"K12a phase split ({tag}; {card}): {name}, n {n}, P {P}, thread 0 of block 0: "
              f"{total} cycles from its first stamp to its last ({total * us_per_cycle:.2f} us "
              f"at {1 / us_per_cycle:.0f} cycles a us), {n_st} stamps; {ms:.4f} ms a launch on "
              f"the device (stamped)", flush=True)
        ps.report(phases, total, us_per_cycle)
        m0 = n // P - 1
        _per_row(phases, {"interior forward": m0, "interior backward": m0,
                          "separators forward": P, "separators backward": P}, us_per_cycle)
    rows = inp["float64"]["packed"][-1].sum(1)
    longest = int(rows.argmax())
    fwd = ("schur.cu", r"^__device__ __forceinline__ void chain_forward\(", None,
           "fwd: stored", FORWARD_ANCHORS)
    bwd = ("schur.cu", r"^__device__ __forceinline__ void chain_backward\(", None,
           "bwd: done", BACKWARD_ANCHORS)
    lib, labels = ps.stamped(tree, base / "k12b", "schur", [
        ("schur.cu", r"^eliminate_lu_kernel\(", "start", "end", ()), fwd, bwd], longest,
        "eliminate_lu_kernel", ["pgo_eliminate_lu"])
    for name in DTYPES:
        packed = inp[name]["packed"]
        call = lambda: dpgo.eliminate_interior_lu(*packed)
        ms = cs.device_ms(call, 30)
        ps.clear(lib)
        call()
        torch.cuda.synchronize()
        phases, total, n_st = ps.split(lib, labels)
        m = packed[0].shape[1]
        print(f"K12b phase split ({tag}; {card}): {name}, partition {longest} ({int(rows[longest])} "
              f"of {m} rows valid), thread 0: {total} cycles from its first stamp to its last "
              f"({total * us_per_cycle:.2f} us), {n_st} stamps; {ms:.4f} ms a launch on the "
              f"device (stamped)", flush=True)
        ps.report(phases, total, us_per_cycle)
        n_rows = int(rows[longest])
        _per_row(phases, {label: n_rows for _, label in FORWARD_ANCHORS + BACKWARD_ANCHORS},
                 us_per_cycle)


if __name__ == "__main__":
    ps.main(__doc__, "k12", "K12a and K12b", ENTRIES, make_inputs, timings, stamps)
    if FAULTS:
        raise SystemExit("faults: " + "; ".join(FAULTS))
