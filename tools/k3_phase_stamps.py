"""Phase split of K3 pko_alpha on the card, from clock64 stamps.

Copies csrc/ of a source tree (this checkout's lidar_odometry_tpu_torch/,
or --src DIR, for example an older commit unpacked with `git archive` into
a directory that .gitignore lists) into build/k3_stamps/<tag>/ with a
stamp (tools/phase_stamps.py) before every phase comment ("// ---- name")
of the kernel in pko.cu and of the GMM fit in gmm.cuh, and one before the
kernel's closing brace, taken in block 0. It builds that copy with the
port's nvcc flags, launches it on chip_smoke.py's phase-3 K3 input (a boot
chunk of 20 bench frames, then frame 20's correspondences, at the
iteration-0 scale) and prints each phase's cycles and share of one launch,
the launch's device time from CUDA events (200 launches queued behind a
spin, so that the host's cost of issuing them is hidden), and the plain
fit's k-means and EM round counts on the same samples.

    python tools/k3_phase_stamps.py [--src DIR]

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


def stamp_sources(src: Path, out: Path) -> list:
    """Write the stamped copy of src's pko.cu and headers to out; return
    the stamp labels by stamp index."""
    stamps = ps.Stamps()
    texts = {"pko.cu": stamps.function((src / "pko.cu").read_text().splitlines(),
                                       r"^pko_kernel\(", last="end"),
             "gmm.cuh": stamps.function((src / "gmm.cuh").read_text().splitlines(),
                                        r"^__device__.*\bgmm_fit_warp\(")}
    ps.copy_sources(src, out, "pko", texts)
    return stamps.labels


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
    import chip_smoke as cs
    from lidar_odometry_tpu_torch import kernels
    from lidar_odometry_tpu_torch.ops import pko
    tree = (args.src or ROOT).resolve()
    tag = "checkout" if args.src is None else tree.name
    out = kernels.BUILD_DIR.parent / "k3_stamps" / tag
    labels = stamp_sources(tree / "lidar_odometry_tpu_torch" / "csrc", out)
    lib = ps.build(out, "pko", out / "libpko_stamped.so", 0, "pko")
    fn = lib.lo_pko_alpha
    fn.argtypes = kernels.KERNELS["pko_alpha"].argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

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
    ms = cs.device_ms(launch, 200)
    ps.clear(lib)
    launch()
    torch.cuda.synchronize()
    phases, total, n = ps.split(lib, labels)
    a_p, c_p, s_p = pko.pko_alpha_index_plain(r, v, scale.reshape(()), True, consts)
    samples = pko.stratified_sample(r.abs() / torch.clamp(s_p, min=1e-6), v, consts.u)
    *_, (km, em) = pko.fit_gmm(samples, consts.pick, rounds=True)
    print(f"K3 phase split ({tag}; {ps.card()}): {int(v.sum())} valid of {r.shape[0]}, alpha "
          f"{int(aux[1])} (plain {int(a_p)}), {total} cycles stamped ({n} stamps), {ms:.4f} ms "
          f"a launch on the device (CUDA events, 200 launches), plain fit: {km} k-means and "
          f"{em} EM rounds")
    ps.report(phases, total, ms * 1e3 / total)


if __name__ == "__main__":
    main()
