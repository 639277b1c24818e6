"""The clock64 phase stamps that the tools/k*_phase_stamps.py take of a
kernel on the card: stamping a copy of its sources at their phase
comments, building the copy with the port's nvcc flags, binding the tree's
wrappers to it (stamped), and reading the stamps back, split by phase.

A stamp is taken by thread 0 of block LO_STAMP_BLOCK (a define of the
build; blockIdx.y and .z 0) and appends (phase, clock64) to a log in device memory. Every
stamped function counts its stamps in a register of its own and writes
a region of the log of its own; the log is read back sorted by clock, so
the stamps of a kernel and of the device functions it calls fall in the
order they ran, and the cycles from one stamp to the next are its
phase's. A phase that runs once a row is summed over the rows.

With LO_STAMP_BLOCK -1 thread 0 of every block (blockIdx.x) stamps, into
EVERY slots of the region of its own; split(..., every=EVERY) then reads
each block's stamps apart (clock64 counts on each SM, so stamps of two
blocks are never compared). A kernel whose tail runs in whichever block
finishes last (a ticket) is read from the block that stamped the tail.

A kernel without phase comments (an older tree's) is stamped at anchors:
(regex, label) pairs, a phase mark put before the first line of the body
that matches each regex, in order.

The tools also share their scaffolding here: the device records of a
call (device_records), the PGO path's GN iterations with the tree's
kernels (pgo_path), the outputs compared bit for bit across the trees of
one call (compare), ptxas's report of a tree's kernels (print_ptxas) and
the command line (main: --src, --plain, --make-inputs, --inputs).

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import re
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "lidar_odometry_tpu_torch" / "csrc"
MARK = re.compile(r"^\s*// ---- (.+?)(?: ----)?\s*$")
REGION = 16384      # stamps a function keeps of one launch
REGIONS = 4
EVERY = 64          # stamps a block keeps when every block stamps
PRELUDE = f"""#include <cuda_runtime.h>
__device__ long long lo_log_t[{REGIONS * REGION}];
__device__ int lo_log_k[{REGIONS * REGION}];
#if LO_STAMP_BLOCK < 0
#define LO_STAMP_AT(r) (lo_i + (int)blockIdx.x * {EVERY})
#define LO_STAMP_OK(r) (lo_i < (r) * {REGION} + {EVERY} && LO_STAMP_AT(r) < ((r) + 1) * {REGION})
#else
#define LO_STAMP_AT(r) lo_i
#define LO_STAMP_OK(r) (blockIdx.x == LO_STAMP_BLOCK && lo_i < ((r) + 1) * {REGION})
#endif
#define LO_STAMP(r, k) \\
  do {{ const long long lo_c = clock64(); \\
    if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && LO_STAMP_OK(r)) {{ \\
      lo_log_t[LO_STAMP_AT(r)] = lo_c; lo_log_k[LO_STAMP_AT(r)] = (k); }} \\
    ++lo_i; }} while (0)
"""
EPILOGUE = f"""
LO_EXPORT int lo_clear_log() {{
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, lo_log_t);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(long long) * {REGIONS * REGION});
  return (int)e;
}}
LO_EXPORT int lo_read_log(long long* t, int* k) {{
  cudaError_t e = cudaMemcpyFromSymbol(t, lo_log_t, sizeof(long long) * {REGIONS * REGION});
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(k, lo_log_k, sizeof(int) * {REGIONS * REGION});
  return (int)e;
}}
"""


class Stamps:
    """The labels of a stamped copy's stamps, by stamp index."""

    def __init__(self):
        self.labels: list = []
        self._regions = 0

    def _stamp(self, region: int, label: str, indent: str) -> str:
        self.labels.append(label)
        return f"{indent}LO_STAMP({region}, {len(self.labels) - 1});"

    def function(self, lines: list, start: str, first: str = None, last: str = None,
                 anchors=()) -> list:
        """`lines` with the function whose first line matches the regex
        `start` stamped: a stamp before each phase comment ("// ---- name")
        of its body (and before each anchor's line, for a body without
        them), and, where given, one labelled `first` at the body's start
        and one labelled `last` before its closing line "}"."""
        region = self._regions
        self._regions += 1
        if region >= REGIONS:
            raise SystemExit(f"more than {REGIONS} stamped functions")
        head = next((i for i, l in enumerate(lines) if re.match(start, l)), None)
        if head is None:
            raise SystemExit(f"no function matching {start!r}")
        body = next(i for i in range(head, len(lines)) if lines[i].rstrip().endswith("{"))
        end = next(i for i in range(body + 1, len(lines)) if lines[i] == "}")
        out = [f"  int lo_i = {region * REGION};"]
        if first:
            out.append(self._stamp(region, first, "  "))
        marks = 0
        todo = list(anchors)
        for line in lines[body + 1:end]:
            m = MARK.match(line)
            if todo and re.search(todo[0][0], line):
                out.append(self._stamp(region, todo.pop(0)[1],
                                       line[:len(line) - len(line.lstrip())]))
                marks += 1
            if m:
                out.append(self._stamp(region, m.group(1), line[:len(line) - len(line.lstrip())]))
                marks += 1
            out.append(line)
        if todo:
            raise SystemExit(f"anchor {todo[0][0]!r} not found in the function {start!r}")
        if not marks:
            raise SystemExit(f"no phase comments ('// ---- name') in the function {start!r}")
        if last:
            out.append(self._stamp(region, last, "  "))
        return lines[:body + 1] + out + lines[end:]


def copy_sources(src: Path, out: Path, source: str, texts: dict) -> None:
    """src's headers and <source>.cu copied to out, the files named in
    `texts` ({file name: lines}) replaced by those lines; a stamped
    <source>.cu gets the prelude and the log's readers."""
    out.mkdir(parents=True, exist_ok=True)
    for f in list(src.glob("*.cuh")) + [src / f"{source}.cu"]:
        if f.name in texts:
            text = "\n".join(texts[f.name]) + "\n"
            if f.suffix == ".cu":
                text = PRELUDE + text + EPILOGUE
        else:
            text = f.read_text()
        (out / f.name).write_text(text)


def build(csrc: Path, source: str, lib_path: Path, block: int, kernel: str):
    """csrc/<source>.cu built with the port's nvcc flags (stamps taken in
    block `block`) into lib_path and loaded; ptxas's lines for the
    functions whose names hold `kernel` printed."""
    from lidar_odometry_tpu_torch import kernels
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DLO_STAMP_BLOCK={block}",
                          "-I", str(csrc), "-o", str(lib_path), str(csrc / f"{source}.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    report = (res.stdout + res.stderr).splitlines()
    for i, line in enumerate(report):
        if kernel in line and "Compiling" in line:
            for l in report[i:i + 4]:
                print(f"ptxas: {l.strip()}")
    return ctypes.CDLL(str(lib_path))


def stamped(tree: Path, out: Path, source: str, specs: list, block: int, kernel: str,
            names: list):
    """The tree's csrc/<source>.cu (and headers) with the functions of
    `specs` [(file, start regex, first, last, anchors if the file has no
    phase comments)] stamped, built into `out` (stamps taken in block
    `block`; ptxas's lines for `kernel` printed), and bound to the tree's
    wrappers of the kernels `names`, which launch the stamped copy from then
    on. Returns (lib, labels)."""
    from lidar_odometry_tpu_torch import kernels
    csrc = tree / "lidar_odometry_tpu_torch" / "csrc"
    stamps = Stamps()
    texts = {}
    for fname, start, first, last, anchors in specs:
        lines = texts.get(fname) or (csrc / fname).read_text().splitlines()
        texts[fname] = stamps.function(lines, start, first=first, last=last, anchors=anchors)
    copy_sources(csrc, out, source, texts)
    lib = build(out, source, out / f"lib{source}_stamped.so", block, kernel)
    for name in names:
        k = kernels.KERNELS[name]
        fn = getattr(lib, f"lo_{name}")
        fn.argtypes = k.argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        k._fn = fn
    return lib, stamps.labels


def sm_us_per_cycle() -> float:
    """Microseconds a cycle of the SM clock: a spin of known cycles timed
    by CUDA events."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / 20_000_000


def clear(lib) -> None:
    """Empty the log: call before the launch whose stamps are read."""
    if lib.lo_clear_log():
        raise SystemExit("clearing the stamp log failed")


def split(lib, labels: list, every: bool = False):
    """The log of the launches since clear(), in the order the stamps ran:
    ({phase: (cycles to the next stamp, summed; stamps)}, total cycles from
    the first stamp to the last, stamps read). With `every` (a build with
    LO_STAMP_BLOCK -1), {block: that triple} for each block that stamped."""
    n = REGIONS * REGION
    t = (ctypes.c_longlong * n)()
    k = (ctypes.c_int * n)()
    if lib.lo_read_log(ctypes.addressof(t), ctypes.addressof(k)):
        raise SystemExit("reading the stamp log failed")
    if every:
        blocks = {}
        for i in range(n):
            if t[i]:
                blocks.setdefault((i % REGION) // EVERY, []).append((t[i], labels[k[i]]))
        return {b: _phases(sorted(st)) for b, st in sorted(blocks.items())}
    return _phases(sorted((t[i], labels[k[i]]) for i in range(n) if t[i]))


def _phases(st: list):
    if len(st) < 2:
        raise SystemExit("fewer than two stamps ran")
    phases = {}
    for (c0, label), (c1, _) in zip(st, st[1:]):
        cyc, hits = phases.get(label, (0, 0))
        phases[label] = (cyc + c1 - c0, hits + 1)
    return phases, st[-1][0] - st[0][0], len(st)


def report(phases: dict, total: int, us_per_cycle: float = None) -> None:
    """Each phase's cycles, share, stamps and cycles a stamp, largest
    first; with `us_per_cycle`, its share of the launch's device time."""
    for label in sorted(phases, key=lambda x: -phases[x][0]):
        cyc, hits = phases[label]
        us = "" if us_per_cycle is None else f"  ~{cyc * us_per_cycle:8.2f} us"
        print(f"  {label:52s} {cyc:10d} cycles {100.0 * cyc / total:6.2f} %  "
              f"{hits:5d} x {cyc / hits:8.1f}{us}")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def device_records(fn) -> int:
    """The device activity records (kernels, memcpy, memset) of one call
    of fn (chip_smoke.device_records)."""
    import chip_smoke as cs
    return cs.device_records(fn)


def pgo_path(tag: str, card: str):
    """The PGO path's GN iterations (gn_iterations on the KITTI-00-sized
    graph, chip_smoke.make_pgo_graph, max_iters 10, tol 1e-6) with the
    tree's kernels: the device ms of each of 5 solves from a fresh upload
    (chip_smoke.device_ms_once) and their median; returns the poses."""
    import statistics
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.parallel import distributed_pgo as dpgo
    init, priors, betweens, _ = cs.make_pgo_graph()
    pk = dpgo.pack_graph(init, priors, betweens)
    ms = []
    for _ in range(5):
        g = dpgo.upload(pk, "cuda")
        ms.append(cs.device_ms_once(lambda: dpgo.gn_iterations(g, 10, 1e-6)))
    it, dxn, ok, _ = g["st"].cpu().tolist()
    known = [m for m in ms if m is not None]
    med = f"{statistics.median(known):.4f}" if known else "n/a"
    print(f"  PGO path ({tag}; {card}): n_pad {pk.n_pad}, {int(it)} GN iterations (|dx| "
          f"{dxn:.3e}, ok {bool(ok)}): median {med} ms on the device over {len(known)} solves "
          f"({ms})", flush=True)
    return g["poses"].clone()


def compare(keep: dict, tag: str, prefix: str) -> None:
    """This tree's outputs, saved to build/<prefix>_outputs_<tag>.pt,
    against every other tree's saved ones, bit for bit."""
    import torch
    here = ROOT / "build" / f"{prefix}_outputs_{tag}.pt"
    torch.save(keep, here)
    bits = lambda t: t.view(torch.int64) if t.dtype == torch.float64 else t
    for other in sorted(here.parent.glob(f"{prefix}_outputs_*.pt")):
        if other == here:
            continue
        theirs = torch.load(other, map_location="cuda")
        same = {k: torch.equal(bits(v), bits(theirs[k])) for k, v in keep.items() if k in theirs}
        print(f"outputs bit-equal to {other.stem[len(prefix) + 9:]}'s: {same}", flush=True)


def print_ptxas(tag: str, entries) -> None:
    """ptxas's registers, stack and spills of the tree's kernels
    `entries` [(source, function)]; a function the tree lacks is named."""
    import chip_smoke as cs
    from lidar_odometry_tpu_torch import kernels
    kernels.build()
    for src, fn in entries:
        try:
            found = kernels.ptxas_entries(src, fn)
        except kernels.KernelError:
            print(f"ptxas {fn} ({tag}): not in this tree's {src}.cu", flush=True)
            continue
        for name, info in found.items():
            print(f"ptxas {cs.entry_name(name)} ({tag}): {info['registers']} registers, "
                  f"{info['stack']} bytes of stack, spills {info['spill_stores']} / "
                  f"{info['spill_loads']} bytes", flush=True)


def main(doc: str, prefix: str, title: str, entries, make_inputs, timings, stamps) -> None:
    """A tool's command line: --make-inputs calls make_inputs(path) with
    this checkout's package; otherwise the tree's (--src, default this
    checkout) ptxas report of `entries`, timings(tag, card, inputs) whose
    outputs go to compare(), and unless --plain stamps(tree, tag, card,
    inputs)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=None,
                    help="a tree holding lidar_odometry_tpu_torch/ (default: this checkout)")
    ap.add_argument("--plain", action="store_true",
                    help="no stamps: ptxas's report and the times alone")
    ap.add_argument("--make-inputs", action="store_true",
                    help="make the inputs with this checkout's package, save them, and stop")
    ap.add_argument("--inputs", type=Path, default=ROOT / "build" / f"{prefix}_inputs.pt",
                    help="the inputs (made by --make-inputs)")
    args = ap.parse_args()
    tree = (args.src or ROOT).resolve()
    tag = "checkout" if args.src is None else tree.name
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree))     # the tree's package and its own wrappers
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{prefix}_phase_stamps: needs a CUDA device")
    from lidar_odometry_tpu_torch import kernels
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {kernels.__file__}, not the package under {tree}")
    if args.make_inputs:
        if args.src is not None:
            raise SystemExit("--make-inputs takes this checkout's package, not --src")
        make_inputs(args.inputs)
        return
    if not args.inputs.exists():
        raise SystemExit(f"{args.inputs} is missing: run with --make-inputs first")
    card_name = card()
    print_ptxas(tag, entries)
    inp = torch.load(args.inputs, map_location="cuda")
    print(f"{title} ({tag}; {card_name}):", flush=True)
    compare(timings(tag, card_name, inp), tag, prefix)
    if not args.plain:
        stamps(tree, tag, card_name, inp)
