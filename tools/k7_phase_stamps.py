"""Device times of K7 bev_raster as the loop prealign issues it, and of the
whole bev_translation_offset, on the card, for this checkout and an older
tree in one call.

Inputs (made once on the card by --make-inputs with this checkout's
package and kept in --inputs, so that every tree of one call runs on the
same tensors): chip_smoke.py's loop query (chip_smoke.loop_query: frame
205 of the loops path's circuit, scanned with 65536 returns, every second
of its 16384 features at a pose drifted by 2 degrees and (0.8, -0.5) m,
against frame 0's keyframe of 16384 features), with the yaw-corrected
T_a that the prealign gives K7.

For each tree:
  * the raster as the tree issues it before its FFTs: an older tree's
    bev_raster returns float32 images (a memset, K7, and then two casts
    to complex64, which this tool adds as the prealign ran them), this
    tree's returns the complex64 images in one launch; device time (CUDA
    events over 30 calls queued behind a ~25 ms spin,
    chip_smoke.device_ms), the time as issued (chip_smoke.time_ms) and the
    device records of one call;
  * the whole bev_translation_offset (raster, FFTs, K7c, inverse FFT,
    argmax) the same three ways;
  * the cells that differ from the tree's plain twin;
  * the prealigned T_init of icp.loop_prealign on the query.
The occupancy (the real part), the offset and T_init of each tree are
kept in build/k7_outputs_<tag>.pt and compared bit for bit with the other
trees' of the call; where the occupancy differs, the cells that moved are
listed.

    python tools/k7_phase_stamps.py --make-inputs
    python tools/k7_phase_stamps.py [--src DIR] --plain [--inputs FILE]

--src DIR: a tree holding lidar_odometry_tpu_torch/ (for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists); default this checkout. ptxas's registers and stack of K7 are
printed from the tree's build. K7 takes no clock64 stamps: without
--plain the tool says so and stops after the times.

It needs the card and nvcc; it imports nothing of JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import phase_stamps as ps  # noqa: E402

ROOT = ps.ROOT
ENTRIES = (("bev_align", "bev_raster_kernel"),)


def make_inputs(path: Path) -> None:
    """chip_smoke.py's loop query and the T_a of its prealign, made on the
    card with this checkout's package; saved to `path`."""
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.io import synthetic
    from lidar_odometry_tpu_torch.ops import bev_align
    gt = synthetic.circuit_trajectory(cs.LOOP_FRAMES, length=30.0, radius=10.0, step=0.6)
    lq = cs.loop_query(cs.make_dense_loop_frames(), gt, cs.kitti_config())
    T_a = bev_align._yaw_corrected(lq["q_pose"], lq["m_pose"], torch.tensor(0.0, device="cuda"))
    keep = {k: lq[k] for k in ("q_pts", "q_mask", "q_pose", "m_pts", "m_mask", "m_pose",
                               "m_world")}
    keep.update(T_a=T_a.contiguous(), center=lq["m_pose"][:3, 3].contiguous())
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(keep, path)
    print(f"inputs: a query of {keep['q_pts'].shape[0]} rows ({int(keep['q_mask'].sum())} valid) "
          f"against a keyframe of {keep['m_pts'].shape[0]} rows ({int(keep['m_mask'].sum())} "
          f"valid); saved to {path}", flush=True)


def _moved_cells(tag: str, occ) -> None:
    """The cells in which this tree's occupancy differs from each other
    tree's saved one."""
    import torch
    for other in sorted((ROOT / "build").glob("k7_outputs_*.pt")):
        if other.stem == f"k7_outputs_{tag}":
            continue
        theirs = torch.load(other, map_location="cuda")["occupancy"]
        diff = (occ != theirs).nonzero().tolist()
        print(f"  occupancy cells that differ from {other.stem[11:]}'s: {len(diff)} "
              f"(image, row, column): {diff[:20]}", flush=True)


def timings(tag: str, card: str, inp) -> dict:
    import torch
    import chip_smoke as cs
    from lidar_odometry_tpu_torch.ops import bev_align, icp
    q, qm, w, wm, c = (inp[k] for k in ("q_pts", "q_mask", "m_world", "m_mask", "center"))
    T_a, T16 = inp["T_a"], inp["T_a"].reshape(16).contiguous()
    raw = bev_align.bev_raster(q, qm, T16, w, wm, c)
    fused = raw.dtype == torch.complex64
    if fused:
        issued = lambda: bev_align.bev_raster(q, qm, T16, w, wm, c)
        what = "bev_raster (complex64 images, one launch)"
    else:
        def issued():
            img = bev_align.bev_raster(q, qm, T16, w, wm, c)
            return img[0].to(torch.complex64), img[1].to(torch.complex64)
        what = "bev_raster + two casts to complex64 (memset, K7, 2 casts)"
    twin = bev_align.bev_raster_plain(q, qm, T16, w, wm, c)
    n_diff = int((raw != twin).sum()) if not fused else int(
        (torch.view_as_real(raw).view(torch.int32)
         != torch.view_as_real(twin).view(torch.int32)).any(-1).sum())
    occ = (raw.real if fused else raw).contiguous()
    print(f"  K7 ({tag}; {card}): {what}: {cs.device_ms(issued, 30):.4f} ms on the device "
          f"({cs.time_ms(issued, 30):.4f} as issued), {ps.device_records(issued)} device "
          f"records a call; {n_diff} cells differ from the twin; {int(occ.sum())} occupied",
          flush=True)
    off_call = lambda: bev_align.bev_translation_offset(q, qm, w, wm, c, T_a=T_a)
    off = off_call()
    print(f"  bev_translation_offset ({tag}; {card}): {cs.device_ms(off_call, 30):.4f} ms on the "
          f"device ({cs.time_ms(off_call, 30):.4f} as issued), {ps.device_records(off_call)} "
          f"device records a call; offset {off.tolist()}", flush=True)
    T_init = icp.loop_prealign(inp["q_pose"], inp["m_pose"], torch.tensor(0.0, device="cuda"),
                               q, qm, inp["m_pts"], inp["m_mask"])
    print(f"  T_init ({tag}): {T_init[:3].flatten().tolist()}", flush=True)
    _moved_cells(tag, occ)
    return dict(occupancy=occ, offset=off, T_init=T_init)


def stamps(tree: Path, tag: str, card: str, inp) -> None:
    print(f"no stamps ({tag}): this tool times K7 only (run it with --plain)", flush=True)


if __name__ == "__main__":
    ps.main(__doc__, "k7", "K7", ENTRIES, make_inputs, timings, stamps)
