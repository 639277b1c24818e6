"""Phase split of K3 pko_alpha on the card, from clock64 stamps.

Copies csrc/pko.cu and csrc/*.cuh of a source tree (this checkout's
lidar_odometry_tpu_torch/, or --src DIR, for example an older commit
unpacked with `git archive` into a directory that .gitignore lists) into
build/k3_stamps/<tag>/ and inserts a stamp, taken by thread 0 of block 0,
before every phase comment ("// ---- name") of the kernel in pko.cu and of
the GMM fit in gmm.cuh, and one before the kernel's closing brace. A
gmm.cuh without phase comments gets a stamp "EM" before the first
`float sum = 0.f;` line of the fit. It builds that copy with the port's
nvcc flags, launches it on chip_smoke.py's phase-3 K3 input (a boot chunk
of 20 bench frames, then frame 20's correspondences, at the iteration-0
scale) and prints each phase's cycles and share of the last launch, the
launch's device time from CUDA events (200 launches queued behind a
spin, so that the host's cost of issuing them is hidden), and the plain
fit's k-means and EM round counts on the same samples.

    python tools/k3_phase_stamps.py [--src DIR]

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MARK = re.compile(r"^\s*// ---- (.+?)(?: ----)?\s*$")
PRELUDE = """#include <cuda_runtime.h>
__device__ long long lo_stamp_buf[32];
#define LO_STAMP(k) \\
  do { if (threadIdx.x == 0 && blockIdx.x == 0) lo_stamp_buf[k] = clock64(); } while (0)
"""
EPILOGUE = """
LO_EXPORT int lo_read_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lo_stamp_buf, sizeof(lo_stamp_buf));
}
"""


def stamp_sources(src: Path, out: Path) -> list:
    """Write the stamped copy of src's pko.cu and headers to out; return
    the stamp labels by stamp index (not in the order they run)."""
    out.mkdir(parents=True, exist_ok=True)
    labels = []

    def stamp(label, indent):
        labels.append(label)
        return f"{indent}LO_STAMP({len(labels) - 1});"

    gmm = (src / "gmm.cuh").read_text().splitlines()
    g_out, in_fit, fallback = [], False, not any(MARK.match(l) for l in gmm)
    for line in gmm:
        if "gmm_fit_warp(" in line:
            in_fit = True
        elif in_fit and line.startswith("}"):
            in_fit = False
        m = MARK.match(line)
        if in_fit and m:
            g_out.append(stamp(m.group(1), " " * (len(line) - len(line.lstrip()))))
        elif in_fit and fallback and line.strip() == "float sum = 0.f;":
            g_out.append(stamp("EM", "  "))
            fallback = False
        g_out.append(line)
    pko = (src / "pko.cu").read_text().splitlines()
    p_out, in_kernel, last_brace = [], False, None
    for line in pko:
        if line.startswith("pko_kernel(") or re.match(r"^__global__.*pko_kernel\(", line):
            in_kernel = True
        m = MARK.match(line)
        if in_kernel and m:
            p_out.append(stamp(m.group(1), " " * (len(line) - len(line.lstrip()))))
        if in_kernel and line == "}":
            in_kernel = False
            last_brace = len(p_out)
        p_out.append(line)
    if last_brace is None or not labels:
        raise SystemExit(f"no K3 kernel or phase comments found under {src}")
    labels.append("end")
    p_out.insert(last_brace, f"  LO_STAMP({len(labels) - 1});")
    for h in src.glob("*.cuh"):
        if h.name != "gmm.cuh":
            (out / h.name).write_text(h.read_text())
    (out / "gmm.cuh").write_text("\n".join(g_out) + "\n")
    (out / "pko.cu").write_text(PRELUDE + "\n".join(p_out) + "\n" + EPILOGUE)
    return labels


def build_pko(csrc: Path, lib_path: Path):
    """csrc/pko.cu built with the port's nvcc flags into lib_path, loaded,
    its ptxas report printed; lo_pko_alpha's argument types set."""
    from lidar_odometry_tpu_torch import kernels
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(csrc), "-o",
                          str(lib_path), str(csrc / "pko.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "pko" in line or "registers" in line or "stack" in line:
            print(f"ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(lib_path))
    lib.lo_pko_alpha.argtypes = kernels.KERNELS["pko_alpha"].argtypes + [ctypes.c_void_p]
    lib.lo_pko_alpha.restype = ctypes.c_int
    return lib


def k3_input():
    """chip_smoke.py's phase-3 K3 input on the card: (r, valid, flags, scale, consts)."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.models import fast_pipeline as fp
    from lidar_odometry_tpu_torch.ops import icp, voxel_filter as vf
    cfg, consts, kw = cs.setup()
    scans, _ = cs.make_scans(cs.CHUNK + 1)
    runner = fp.make_chunk_runner(cfg, consts, **kw)
    carry = fp.init_carry(0, cs.C1, device="cuda")
    carry, _ = runner(carry, torch.as_tensor(scans[:cs.CHUNK], device="cuda"))
    raw = torch.as_tensor(scans[cs.CHUNK], device="cuda")
    feat, mask, _ = vf.voxel_filter(raw, raw.shape[0], voxel_size=0.5, stride=1,
                                    out_capacity=cs.SCAN_CAP, compact_keys=True)
    T = (carry.T_prev @ carry.velocity).reshape(16).contiguous()
    flags = torch.zeros((3,), dtype=torch.int32, device="cuda")
    _, r, v = icp.icp_correspond(feat, mask, T, flags, carry.map_state, cfg)
    return r, v, flags, torch.ones((1,), device="cuda"), consts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=None,
                    help="a tree holding lidar_odometry_tpu_torch/ (default: this checkout)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k3_phase_stamps: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.ops import pko
    tree = (args.src or ROOT).resolve()
    tag = "checkout" if args.src is None else tree.name
    out = kernels.BUILD_DIR.parent / "k3_stamps" / tag
    labels = stamp_sources(tree / "lidar_odometry_tpu_torch" / "csrc", out)
    lib = build_pko(out, out / "libpko_stamped.so")
    fn = lib.lo_pko_alpha
    lib.lo_read_stamps.argtypes = [ctypes.c_void_p]
    lib.lo_read_stamps.restype = ctypes.c_int

    r, v, flags, scale, consts = k3_input()
    n_alpha, n_grid = consts.Q.shape
    aux = torch.empty((2,), dtype=torch.int32, device="cuda")
    s_out = torch.empty((1,), device="cuda")

    def launch():
        err = fn(r.data_ptr(), v.data_ptr(), r.shape[0], 1, flags.data_ptr(), scale.data_ptr(), 1,
                 consts.u.data_ptr(), consts.pick.data_ptr(), consts.alphas.data_ptr(),
                 consts.r_grid.data_ptr(), consts.Q.data_ptr(), n_alpha, n_grid,
                 s_out.data_ptr(), aux.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: cudaError {err}")

    for _ in range(30):
        launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # the card waits while the host queues the launches
    start.record()
    for _ in range(200):
        launch()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 200
    buf = (ctypes.c_longlong * 32)()
    if lib.lo_read_stamps(ctypes.addressof(buf)):
        raise SystemExit("reading the stamps failed")
    # stamps in the order they ran (clock64 of one SM); a stamp left 0 did not run
    st = sorted((c, lab) for c, lab in zip(list(buf), labels) if c)
    total = st[-1][0] - st[0][0]
    a_p, c_p, s_p = pko.pko_alpha_index_plain(r, v, scale.reshape(()), True, consts)
    samples = pko.stratified_sample(r.abs() / torch.clamp(s_p, min=1e-6), v, consts.u)
    *_, (km, em) = pko.fit_gmm(samples, consts.pick, rounds=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"K3 phase split ({tag}; {card}): {int(v.sum())} valid of {r.shape[0]}, alpha "
          f"{int(aux[1])} (plain {int(a_p)}), {total} cycles stamped, {ms:.4f} ms a launch "
          f"on the device (CUDA events, 200 launches), plain fit: {km} k-means and {em} EM rounds")
    for (c0, label), (c1, _) in zip(st, st[1:]):
        cyc = c1 - c0
        print(f"  {label:50s} {cyc:8d} cycles {100.0 * cyc / total:6.2f} %  "
              f"~{ms * 1e3 * cyc / total:8.2f} us")


if __name__ == "__main__":
    main()
