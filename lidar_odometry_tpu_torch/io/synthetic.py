"""Synthetic LiDAR world + scan generator.

The reference has no test data in-tree; this module provides a structured
planar world (ground + building facades — the geometry the surfel map is
designed for) and simulated scans along a trajectory, used by the
integration tests and by bench.py when no KITTI data is available.
Scans are sensor-frame point sets sampled from world surfaces within
range, with configurable noise — enough to exercise voxel filtering,
surfel extraction, ICP convergence, loop closure, and PGO end-to-end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Rect:
    origin: np.ndarray  # (3,)
    u: np.ndarray       # (3,) edge vector
    v: np.ndarray       # (3,) edge vector

    @property
    def area(self) -> float:
        return float(np.linalg.norm(np.cross(self.u, self.v)))


def make_world(seed: int = 0, extent: float = 120.0, n_buildings: int = 24) -> List[Rect]:
    """Ground plane + random axis-aligned building walls in [-extent, extent]^2.

    The ground is tiled (20 m tiles) so that distance-weighted scan
    sampling balances it fairly against nearby walls — one giant rect
    would swallow the sampling budget and leave x/y/yaw unobservable.
    """
    rng = np.random.default_rng(seed)
    rects: List[Rect] = []
    tile = 20.0
    n_tiles = max(int(np.ceil(2 * extent / tile)), 1)
    for i in range(n_tiles):
        for j in range(n_tiles):
            rects.append(Rect(
                np.array([-extent + i * tile, -extent + j * tile, 0.0]),
                np.array([tile, 0.0, 0.0]),
                np.array([0.0, tile, 0.0])))
    for _ in range(n_buildings):
        cx, cy = rng.uniform(-extent * 0.9, extent * 0.9, 2)
        w, d, h = rng.uniform(5, 15), rng.uniform(5, 15), rng.uniform(4, 10)
        # keep a clear corridor along the x axis for the trajectory
        if abs(cy) < 6.0:
            cy = np.sign(cy or 1.0) * (6.0 + abs(cy))
        x0, y0 = cx - w / 2, cy - d / 2
        rects += [
            Rect(np.array([x0, y0, 0.0]), np.array([w, 0, 0]), np.array([0, 0, h])),
            Rect(np.array([x0, y0 + d, 0.0]), np.array([w, 0, 0]), np.array([0, 0, h])),
            Rect(np.array([x0, y0, 0.0]), np.array([0, d, 0]), np.array([0, 0, h])),
            Rect(np.array([x0 + w, y0, 0.0]), np.array([0, d, 0]), np.array([0, 0, h])),
        ]
    return rects


def straight_trajectory(n_frames: int, step: float = 0.5, height: float = 1.8) -> np.ndarray:
    """(F, 4, 4) poses moving along +x."""
    poses = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    poses[:, 0, 3] = np.arange(n_frames) * step
    poses[:, 2, 3] = height
    return poses


def loop_trajectory(n_frames: int, radius: float = 40.0, height: float = 1.8,
                    revolutions: float = 1.05) -> np.ndarray:
    """(F, 4, 4) circular trajectory that closes a loop (for loop-closure
    and PGO tests)."""
    poses = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    theta = np.linspace(0, 2 * np.pi * revolutions, n_frames)
    for i, th in enumerate(theta):
        c, s = np.cos(th), np.sin(th)
        # heading tangent to the circle
        poses[i, :3, :3] = np.array([[-s, -c, 0], [c, -s, 0], [0, 0, 1]], np.float32)
        poses[i, 0, 3] = radius * c
        poses[i, 1, 3] = radius * s
        poses[i, 2, 3] = height
    return poses


def circuit_trajectory(n_frames: int, length: float = 120.0,
                       radius: float = 25.0, step: float = 0.65,
                       height: float = 1.8) -> np.ndarray:
    """(F, 4, 4) stadium-circuit poses (two straights + two semicircular
    ends), driven for as many laps as n_frames*step covers. KITTI-07-shaped
    workload: rotation-rich corners and full-trajectory revisits on every
    lap after the first (the hard accuracy benchmark of the round-1
    verdict). Heading is tangent to the path."""
    half = length / 2.0
    per = 2.0 * length + 2.0 * np.pi * radius
    poses = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    for i in range(n_frames):
        s = (i * step) % per
        if s < length:                      # bottom straight, heading +x
            x, y, phi = -half + s, -radius, 0.0
        elif s < length + np.pi * radius:   # right semicircle
            a = (s - length) / radius
            x = half + radius * np.sin(a)
            y = -radius * np.cos(a)
            phi = a
        elif s < 2 * length + np.pi * radius:  # top straight, heading -x
            x, y, phi = half - (s - length - np.pi * radius), radius, np.pi
        else:                               # left semicircle
            a = (s - 2 * length - np.pi * radius) / radius
            x = -half - radius * np.sin(a)
            y = radius * np.cos(a)
            phi = np.pi + a
        c, sn = np.cos(phi), np.sin(phi)
        poses[i, :3, :3] = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]],
                                    np.float32)
        poses[i, 0, 3] = x
        poses[i, 1, 3] = y
        poses[i, 2, 3] = height
    return poses


@dataclass
class MovingBox:
    """A dynamic object: an axis-aligned box sliding along a velocity
    vector (cars/pedestrians for the hardened accuracy workloads — the
    reference is evaluated on real KITTI which is full of them)."""
    center: np.ndarray    # (3,) at t=0 (z = half height)
    size: np.ndarray      # (3,) full extents
    velocity: np.ndarray  # (3,) m/frame


def make_dynamic_objects(seed: int, n: int, extent: float,
                         speed: float = 0.3,
                         near_path: np.ndarray = None,
                         path_offset: float = 8.0) -> List[MovingBox]:
    """With `near_path` ((K, 2) xy centerline), boxes spawn within
    `path_offset` of the trajectory — where real traffic is, and where
    they actually occupy scan returns (uniform placement over a 100 m
    scene leaves them a negligible point fraction)."""
    rng = np.random.default_rng(seed + 77)
    objs = []
    for _ in range(n):
        size = np.array([rng.uniform(1.5, 4.5), rng.uniform(1.5, 2.2),
                         rng.uniform(1.4, 2.0)])
        if near_path is not None:
            p = near_path[rng.integers(len(near_path))]
            # 4 m standoff keeps a clear lane; beyond ~path_offset the
            # box stops occupying a meaningful solid angle
            radius = rng.uniform(4.0, max(path_offset, 6.0))
            ang_off = rng.uniform(0, 2 * np.pi)
            center = np.array([p[0] + radius * np.cos(ang_off),
                               p[1] + radius * np.sin(ang_off),
                               size[2] / 2.0])
        else:
            center = np.array([rng.uniform(-extent, extent),
                               rng.uniform(-extent, extent), size[2] / 2.0])
        ang = rng.uniform(0, 2 * np.pi)
        vel = np.array([np.cos(ang), np.sin(ang), 0.0]) * \
            rng.uniform(0.3, 1.0) * speed
        objs.append(MovingBox(center, size, vel))
    return objs


def _box_rects(b: MovingBox, t: float) -> List[Rect]:
    c = b.center + b.velocity * t
    w, d, h = b.size
    x0, y0 = c[0] - w / 2, c[1] - d / 2
    return [
        Rect(np.array([x0, y0, 0.0]), np.array([w, 0, 0]), np.array([0, 0, h])),
        Rect(np.array([x0, y0 + d, 0.0]), np.array([w, 0, 0]), np.array([0, 0, h])),
        Rect(np.array([x0, y0, 0.0]), np.array([0, d, 0]), np.array([0, 0, h])),
        Rect(np.array([x0 + w, y0, 0.0]), np.array([0, d, 0]), np.array([0, 0, h])),
    ]


def make_clutter(seed: int, n_blobs: int, extent: float) -> np.ndarray:
    """(K, 4) non-planar clutter blobs [x, y, z, radius] — vegetation-like
    scatterers that must NOT become surfels (they stress the planarity
    rejection, reference VoxelMap.cpp:244-253)."""
    rng = np.random.default_rng(seed + 131)
    c = np.stack([rng.uniform(-extent, extent, n_blobs),
                  rng.uniform(-extent, extent, n_blobs),
                  rng.uniform(0.5, 2.5, n_blobs),
                  rng.uniform(0.8, 2.0, n_blobs)], axis=1)
    return c.astype(np.float32)


def sample_scan_rings(world: List[Rect], pose: np.ndarray,
                      rng: np.random.Generator, *, n_rings: int = 64,
                      azimuth_steps: int = 900, max_range: float = 80.0,
                      noise: float = 0.01,
                      elevation_range=(-24.8, 2.0),
                      dynamic_objects: List[MovingBox] = (),
                      t: float = 0.0,
                      clutter: np.ndarray = None,
                      clutter_fraction: float = 0.05,
                      return_dynamic_mask: bool = False):
    """Spinning multi-beam scan by RAY CASTING (the KITTI HDL-64E beam
    model: n_rings elevation angles x azimuth_steps yaw steps, so returns
    carry the ring/arc structure real scans have — dense near-sensor
    ground rings, range-dependent sparsity, vertical stripes on walls —
    unlike the area-weighted sampler above). Rays hit the nearest of the
    static world, the dynamic boxes at time t, and spherical clutter
    blobs (non-planar scatter). Returns (M, 3) sensor-frame points (and,
    with return_dynamic_mask, an (M,) bool marking dynamic-object hits).
    """
    sensor = pose[:3, 3]
    R = pose[:3, :3]
    elev = np.deg2rad(np.linspace(elevation_range[0], elevation_range[1],
                                  n_rings))
    azim = np.linspace(-np.pi, np.pi, azimuth_steps, endpoint=False)
    azim = azim + rng.uniform(0, 2 * np.pi / azimuth_steps)
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(azim), np.sin(azim)
    # (n_rings, azimuth_steps, 3) world-frame directions
    d = np.stack([ce[:, None] * ca[None, :], ce[:, None] * sa[None, :],
                  np.broadcast_to(se[:, None], (n_rings, azimuth_steps))],
                 axis=-1)
    d = (d.reshape(-1, 3) @ R.T).astype(np.float64)
    o = sensor.astype(np.float64)

    t_static = _raycast_rects(o, d, list(world), max_range)
    dyn_rects = []
    for b in dynamic_objects:
        dyn_rects += _box_rects(b, t)
    t_dyn = _raycast_rects(o, d, dyn_rects, max_range)
    t_hit = np.minimum(t_static, t_dyn)

    # spherical clutter blobs: ray-sphere intersection, fuzzy surface
    if clutter is not None and len(clutter):
        oc = clutter[:, :3].astype(np.float64) - o[None, :]   # (K, 3)
        r2 = (clutter[:, 3].astype(np.float64)) ** 2
        proj = d @ oc.T                                        # (N, K)
        perp2 = np.sum(oc * oc, axis=1)[None, :] - proj ** 2
        disc = r2[None, :] - perp2
        hit = (disc > 0) & (proj > 0.5)
        tc = np.where(hit, proj - np.sqrt(np.maximum(disc, 0.0)), np.inf)
        # only a fraction of rays return from the porous scatterer
        porous = rng.random(tc.shape) < max(clutter_fraction * 6, 0.1)
        tc = np.where(porous, tc, np.inf)
        t_hit = np.minimum(t_hit, tc.min(axis=1))

    got = np.isfinite(t_hit) & (t_hit < max_range)
    pts = o[None, :] + d[got] * t_hit[got][:, None]
    if noise > 0:
        # range noise along the ray (how real LiDAR noise behaves)
        pts = pts + d[got] * rng.standard_normal(
            (got.sum(), 1)) * noise
    out = ((pts - sensor[None, :]) @ R).astype(np.float32)
    if return_dynamic_mask:
        return out, (t_dyn <= t_hit)[got]
    return out


def _raycast_rects(o: np.ndarray, d: np.ndarray, rects: List[Rect],
                   max_range: float) -> np.ndarray:
    """Min hit distance per ray against planar rects, grouped by plane
    axis for vectorized ray-plane intersection. Rects must be axis-plane
    aligned in their NORMAL (u, v may be arbitrary in-plane); general
    rects fall back to the dominant-normal-axis plane test, which is
    exact for the vertical corridor walls make_corridor_world builds."""
    n_rays = d.shape[0]
    t_hit = np.full(n_rays, np.inf)
    by_axis = {0: [], 1: [], 2: []}
    for r in rects:
        nrm = np.cross(r.u, r.v)
        axis = int(np.argmax(np.abs(nrm)))
        by_axis[axis].append(r)
    for axis, rs in by_axis.items():
        if not rs:
            continue
        axis_aligned = all(
            abs(np.cross(r.u, r.v)[axis]) > 0.999 * np.linalg.norm(
                np.cross(r.u, r.v)) for r in rs)
        if axis_aligned:
            t_hit = np.minimum(t_hit, _raycast_axis_rects(
                o, d, rs, axis, max_range))
        else:
            t_hit = np.minimum(t_hit, _raycast_general_rects(
                o, d, rs, max_range))
    return t_hit


def _raycast_axis_rects(o, d, rs, axis, max_range):
    a1, a2 = [i for i in range(3) if i != axis]
    c = np.array([r.origin[axis] for r in rs])
    lo1 = np.array([min(r.origin[a1], r.origin[a1] + r.u[a1] + r.v[a1])
                    for r in rs])
    hi1 = np.array([max(r.origin[a1], r.origin[a1] + r.u[a1] + r.v[a1])
                    for r in rs])
    lo2 = np.array([min(r.origin[a2], r.origin[a2] + r.u[a2] + r.v[a2])
                    for r in rs])
    hi2 = np.array([max(r.origin[a2], r.origin[a2] + r.u[a2] + r.v[a2])
                    for r in rs])
    n_rays = d.shape[0]
    t_hit = np.full(n_rays, np.inf)
    # chunk rays to bound the (rays x rects) temporary
    chunk = max(1, 8_000_000 // max(len(rs), 1))
    for s0 in range(0, n_rays, chunk):
        dd = d[s0:s0 + chunk]
        da = dd[:, axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = (c[None, :] - o[axis]) / da[:, None]
        p1 = o[a1] + tt * dd[:, a1][:, None]
        p2 = o[a2] + tt * dd[:, a2][:, None]
        ok = ((tt > 0.5) & (tt < max_range)
              & (p1 >= lo1[None, :]) & (p1 <= hi1[None, :])
              & (p2 >= lo2[None, :]) & (p2 <= hi2[None, :]))
        tt = np.where(ok, tt, np.inf)
        t_hit[s0:s0 + chunk] = np.minimum(t_hit[s0:s0 + chunk],
                                          tt.min(axis=1))
    return t_hit


def _raycast_general_rects(o, d, rs, max_range):
    """Exact ray/parallelogram intersection for arbitrarily-oriented
    rects (corridor wall segments along diagonal path legs)."""
    org = np.stack([r.origin for r in rs]).astype(np.float64)   # (K, 3)
    u = np.stack([r.u for r in rs]).astype(np.float64)
    v = np.stack([r.v for r in rs]).astype(np.float64)
    nrm = np.cross(u, v)
    n_rays = d.shape[0]
    t_hit = np.full(n_rays, np.inf)
    chunk = max(1, 4_000_000 // max(len(rs), 1))
    uu = np.sum(u * u, axis=1)
    vv = np.sum(v * v, axis=1)
    uv = np.sum(u * v, axis=1)
    det = np.maximum(uu * vv - uv * uv, 1e-12)
    for s0 in range(0, n_rays, chunk):
        dd = d[s0:s0 + chunk]
        denom = dd @ nrm.T                                       # (C, K)
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = ((org - o[None, :]) * nrm).sum(axis=1)[None, :] / denom
        p = o[None, None, :] + tt[..., None] * dd[:, None, :]    # (C, K, 3)
        w = p - org[None, :, :]
        wu = np.sum(w * u[None, :, :], axis=-1)
        wv = np.sum(w * v[None, :, :], axis=-1)
        a = (wu * vv[None, :] - wv * uv[None, :]) / det[None, :]
        b = (wv * uu[None, :] - wu * uv[None, :]) / det[None, :]
        ok = ((tt > 0.5) & (tt < max_range) & (a >= 0) & (a <= 1)
              & (b >= 0) & (b <= 1))
        tt = np.where(ok, tt, np.inf)
        t_hit[s0:s0 + chunk] = np.minimum(t_hit[s0:s0 + chunk],
                                          tt.min(axis=1))
    return t_hit


def make_corridor_world(path_xy: np.ndarray, *, width: float = 4.0,
                        height: float = 3.0, tile: float = 5.0,
                        extent: float = 45.0) -> List[Rect]:
    """Indoor world: vertical walls offset left/right of a closed
    centerline polyline (MID360-style corridor loop), plus floor and
    ceiling tiles. `path_xy` is (K, 2), closed implicitly."""
    rects: List[Rect] = []
    n_tiles = max(int(np.ceil(2 * extent / tile)), 1)
    for i in range(n_tiles):
        for j in range(n_tiles):
            org = np.array([-extent + i * tile, -extent + j * tile, 0.0])
            rects.append(Rect(org, np.array([tile, 0.0, 0.0]),
                              np.array([0.0, tile, 0.0])))
            rects.append(Rect(org + np.array([0.0, 0.0, height]),
                              np.array([tile, 0.0, 0.0]),
                              np.array([0.0, tile, 0.0])))
    k = len(path_xy)
    for i in range(k):
        p0 = path_xy[i]
        p1 = path_xy[(i + 1) % k]
        seg = p1 - p0
        ln = np.linalg.norm(seg)
        if ln < 1e-6:
            continue
        nrm = np.array([-seg[1], seg[0]]) / ln
        for side in (+1.0, -1.0):
            off = nrm * (width / 2.0) * side
            org = np.array([p0[0] + off[0], p0[1] + off[1], 0.0])
            rects.append(Rect(org, np.array([seg[0], seg[1], 0.0]),
                              np.array([0.0, 0.0, height])))
    return rects


def sample_scan(world: List[Rect], pose: np.ndarray, n_points: int,
                rng: np.random.Generator, max_range: float = 60.0,
                noise: float = 0.01, wall_boost: float = 4.0) -> np.ndarray:
    """Sample a sensor-frame scan: world-surface points within max_range of
    the sensor, area-weighted across surfaces, with Gaussian noise.

    `wall_boost` over-weights vertical surfaces: a spinning LiDAR
    concentrates beams near the horizon, so walls are sampled far more
    densely than the ground per unit area — without it, surfel maps lack
    the vertical constraints that make x/y/yaw observable.
    """
    sensor = pose[:3, 3]
    areas = np.array([r.area for r in world])
    # bias sampling toward surfaces near the sensor
    centers = np.stack([r.origin + 0.5 * (r.u + r.v) for r in world])
    d = np.linalg.norm(centers - sensor[None, :], axis=-1)
    normals_z = np.array([abs(np.cross(r.u, r.v)[2]) / max(r.area, 1e-9)
                          for r in world])
    vertical = normals_z < 0.5
    weights = areas / np.maximum(d, 5.0) ** 2
    weights = np.where(vertical, weights * wall_boost, weights)
    weights /= weights.sum()

    pts = np.zeros((0, 3), np.float32)
    for _ in range(8):
        need = n_points - len(pts)
        if need <= 0:
            break
        k = max(need * 2, 1024)
        ridx = rng.choice(len(world), size=k, p=weights)
        a = rng.random(k)[:, None]
        b = rng.random(k)[:, None]
        cand = np.stack([world[i].origin for i in ridx]) \
            + a * np.stack([world[i].u for i in ridx]) \
            + b * np.stack([world[i].v for i in ridx])
        keep = np.linalg.norm(cand - sensor[None, :], axis=-1) < max_range
        pts = np.concatenate([pts, cand[keep].astype(np.float32)])
    pts = pts[:n_points]
    if noise > 0:
        pts = pts + rng.standard_normal(pts.shape).astype(np.float32) * noise
    # world -> sensor frame
    R, t = pose[:3, :3], pose[:3, 3]
    return ((pts - t) @ R).astype(np.float32)


def _so3_exp_np(w: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(w))
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(theta) / theta * K + (1.0 - np.cos(theta)) / theta ** 2 * K @ K


def revisit_pose_graph(n: int, n_loops: int, seed: int = 0, *, length: float = 250.0,
                       radius: float = 60.0, min_gap: int = 50):
    """A pose graph of n keyframes 1 m apart on a stadium circuit (straights
    of `length`, ends of `radius`) driven for several laps, the revisit
    structure of a city drive: the initial poses chain odometry that drifts
    by Gaussian noise of 2 cm and 2 mrad a keyframe on all six axes; n_loops
    loop edges join a keyframe to its revisit one or more laps later (at
    least min_gap keyframes apart) with the true relative pose; one prior
    pins keyframe 0. Information is diagonal, GTSAM order [rot, trans]:
    1e4 for the prior; 1e4 (rotation, 0.01 rad) and 1e2 (translation,
    0.1 m) for every between factor. Returns (initial poses (n,4,4) f64,
    priors, betweens, true poses), the factors as PoseGraphOptimizer and
    gn_optimize_device take them: priors (key, measured, sqrt_info),
    betweens (from, to, measured, sqrt_info)."""
    step, drift_t, drift_r = 1.0, 0.02, 0.002
    rng = np.random.default_rng(seed)
    true = circuit_trajectory(n, length=length, radius=radius, step=step).astype(np.float64)
    for T in true:   # exact rotations about z in float64
        phi = np.arctan2(T[1, 0], T[0, 0])
        T[:3, :3] = [[np.cos(phi), -np.sin(phi), 0.0], [np.sin(phi), np.cos(phi), 0.0],
                     [0.0, 0.0, 1.0]]
    sq_between = np.diag([1.0 / 0.01] * 3 + [1.0 / 0.1] * 3)
    init = [true[0].copy()]
    betweens = []
    for i in range(1, n):
        rel = np.linalg.inv(true[i - 1]) @ true[i]
        noise = np.eye(4)
        noise[:3, :3] = _so3_exp_np(rng.normal(0.0, drift_r, 3))
        noise[:3, 3] = rng.normal(0.0, drift_t, 3)
        rel = rel @ noise
        init.append(init[-1] @ rel)
        betweens.append((i - 1, i, rel, sq_between))
    lap = int(round((2.0 * length + 2.0 * np.pi * radius) / step))
    if lap < min_gap or n <= lap:
        raise ValueError("the circuit is not revisited within n keyframes")
    for _ in range(n_loops):
        i = int(rng.integers(0, n - lap))
        j = i + lap * int(rng.integers(1, (n - 1 - i) // lap + 1))
        betweens.append((i, j, np.linalg.inv(true[i]) @ true[j], sq_between))
    priors = [(0, true[0].copy(), np.eye(6) / 1e-2)]
    return np.stack(init), priors, betweens, true


def voxel_runs(counts, n_invalid: int = 0, seed: int = 0, voxel: float = 0.5) -> np.ndarray:
    """Points that fill one distinct voxel cell each per entry of `counts`
    (that many points in the cell, inside it by at least 5 % of the voxel
    on every axis), plus n_invalid NaN rows, shuffled: (sum(counts) +
    n_invalid, 3) float32. Sorted by their voxel key, the points form runs
    of exactly those lengths, in an order set by the cells, then the
    invalid rows; the cells lie within +-400 voxels of the origin, inside
    the compact key's envelope."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    flat = rng.choice(800 ** 3, size=len(counts), replace=False)
    cells = np.stack([flat // 800 ** 2, flat // 800 % 800, flat % 800], -1) - 400
    pts = np.repeat(cells, counts, axis=0) + rng.uniform(0.05, 0.95, (int(counts.sum()), 3))
    pts = np.concatenate([pts * voxel, np.full((n_invalid, 3), np.nan)]).astype(np.float32)
    return pts[rng.permutation(len(pts))]


def separator_system(D: int, n_loops: int, seed: int = 0, spd: bool = True):
    """Inputs of the separator solve (K10c) for D separators with no
    partitioned graph behind them: separator I is pose I of D + 1 padded
    poses, coupled to I + 1 by off[I]; diag blocks SPD with 30 on the
    diagonal, the Schur blocks S (D, 4, 6, 6) (S_ll and S_rr symmetric,
    S_rl = S_lr^T, as an elimination gives them) and r (D, 2, 6) and the
    couplings below 0.5 in magnitude, so the assembled system is symmetric,
    diagonally dominant and SPD. n_loops loop blocks join random separator pairs at
    least two apart (D >= 3), the first pair twice, the last loop invalid.
    With spd=False separator D // 2's diagonal block is negated (not
    positive definite). Returns a dict of float64 and int32 arrays: diag,
    off, b, lb, S, r and the plan's seps, adj_mask, adj_off, loop_a,
    loop_b, loop_valid."""
    rng = np.random.default_rng(seed)
    n_pad = D + 1
    small = lambda *shape: rng.uniform(-0.5, 0.5, shape)
    diag = small(n_pad, 6, 6)
    diag = 0.5 * (diag + diag.transpose(0, 2, 1)) + 30.0 * np.eye(6)
    if not spd:
        diag[D // 2] *= -1.0
    pairs = []
    for _ in range(n_loops if D >= 3 else 0):
        a = int(rng.integers(0, D - 2))
        pairs.append((a, int(rng.integers(a + 2, D))))
    if pairs:
        pairs.append(pairs[0])
    L = len(pairs)
    S = 0.1 * small(D, 4, 6, 6)
    S[:, 0] = 0.5 * (S[:, 0] + S[:, 0].transpose(0, 2, 1))
    S[:, 3] = 0.5 * (S[:, 3] + S[:, 3].transpose(0, 2, 1))
    S[:, 2] = S[:, 1].transpose(0, 2, 1)
    return dict(
        diag=diag, off=small(n_pad - 1, 6, 6), b=rng.normal(0.0, 1.0, (n_pad, 6)),
        lb=0.25 * small(L, 6, 6), S=S, r=small(D, 2, 6),
        seps=np.arange(D, dtype=np.int32), adj_mask=(np.arange(D) < D - 1).astype(np.int32),
        adj_off=np.minimum(np.arange(D), n_pad - 2).astype(np.int32),
        loop_a=np.array([p[0] for p in pairs], np.int32).reshape(L),
        loop_b=np.array([p[1] for p in pairs], np.int32).reshape(L),
        loop_valid=(np.arange(L) < L - 1).astype(np.int32))


def scatter_add_inputs(counts, n_invalid: int = 0, seed: int = 0, unplaced_every: int = 0,
                       voxel: float = 0.5):
    """The inputs of the map update's per-voxel accumulation (K4b) over
    voxel_runs' points: the points (p, 3) float32 in their original order;
    s_idx, the stable sort of their voxel keys (the invalid rows last, as
    one run); firstk and valid_s in that order; and by point, placed, pslot
    (each distinct parent a distinct slot of c1 = parents + 7, every
    `unplaced_every`-th parent unplaced: slot -1) and ch_off (the child
    offset of the cell in its parent, 0-26); l0 (c1 * 27 + 1, 4) float32
    with integer counts and finite sums in every row but the zero sink
    row last. Returns a dict of numpy arrays and c1."""
    rng = np.random.default_rng(seed + 1)
    pts = voxel_runs(counts, n_invalid, seed=seed, voxel=voxel)
    ok = np.all(np.isfinite(pts), -1)
    cell = np.floor(np.where(ok[:, None], pts, 0.0) / np.float32(voxel)).astype(np.int64)
    key = np.where(ok, ((cell[:, 0] + 512) * 1024 + cell[:, 1] + 512) * 1024 + cell[:, 2] + 512,
                   np.iinfo(np.int64).max)
    s_idx = np.argsort(key, kind="stable")
    s_key = key[s_idx]
    firstk = np.ones(len(pts), bool)
    firstk[1:] = s_key[1:] != s_key[:-1]
    par = np.floor_divide(cell, 3)
    m = cell - 3 * par
    ch_off = (m[:, 0] * 3 + m[:, 1]) * 3 + m[:, 2]
    uniq, inv = np.unique(par[ok], axis=0, return_inverse=True)
    c1 = len(uniq) + 7
    slots = rng.permutation(c1)[:len(uniq)]
    if unplaced_every:
        slots[::unplaced_every] = -1
    pslot = np.full(len(pts), -1, np.int64)
    pslot[ok] = slots[inv.reshape(-1)]
    cnt = rng.integers(0, 6, c1 * 27).astype(np.float32)
    l0 = np.concatenate([cnt[:, None], cnt[:, None] * rng.uniform(-50, 50, (c1 * 27, 3))], 1)
    l0 = np.concatenate([l0, np.zeros((1, 4))]).astype(np.float32)
    return dict(pts=pts, s_idx=s_idx, firstk=firstk, valid_s=ok[s_idx], placed=ok & (pslot >= 0),
                pslot=pslot, ch_off=ch_off, l0=l0), c1


def backsub_system(n_pad: int, n_parts: int, seed: int = 0, zero_rows: int = 0):
    """The inputs of the back-substitution and retraction (K10d) for n_pad
    poses cut into n_parts partitions (separators evenly spaced, the last
    at n_pad - 1; the partition plan of distributed_pgo.make_plan): xs (D,
    6) and F, G (D, max_m, 6, 6), g (D, max_m, 6) of an elimination, with
    entries that give |dx| of ~1e-2 a pose; random poses (n_pad, 4, 4) in
    SE(3) within 100 m; real_mask 1 but on the last `zero_rows` poses, and
    pose_row (each pose's plan row, or -(separator + 1)) as pack_graph
    writes it. Returns (dict of float64 and int32 arrays, plan)."""
    from ..parallel.distributed_pgo import make_plan
    rng = np.random.default_rng(seed)
    seps = sorted(set(np.linspace(0, n_pad - 1, n_parts + 1)[1:].round().astype(int).tolist()))
    plan = make_plan(n_pad, seps)
    D, max_m = plan["D"], plan["max_m"]
    poses = np.tile(np.eye(4), (n_pad, 1, 1))
    poses[:, :3, :3] = [_so3_exp_np(w) for w in rng.normal(0.0, 1.0, (n_pad, 3))]
    poses[:, :3, 3] = rng.uniform(-100.0, 100.0, (n_pad, 3))
    real_mask = np.ones(n_pad)
    real_mask[n_pad - zero_rows:] = 0.0
    pose_row = np.zeros(n_pad, np.int32)
    for i, sp in enumerate(plan["seps"]):
        pose_row[sp] = -(i + 1)
    kk, rr = np.nonzero(plan["valid"])
    pose_row[plan["int_idx"][kk, rr]] = kk * max_m + rr
    arrays = dict(poses=poses, xs=rng.normal(0.0, 1e-2, (D, 6)),
                  F=rng.uniform(-0.3, 0.3, (D, max_m, 6, 6)),
                  G=rng.uniform(-0.3, 0.3, (D, max_m, 6, 6)),
                  g=rng.normal(0.0, 1e-2, (D, max_m, 6)), real_mask=real_mask,
                  pose_row=pose_row,
                  **{k: plan[k].astype(np.int32) for k in ("int_idx", "valid", "has_left",
                                                          "xl_idx", "seps")})
    return arrays, plan


def chain_system(n_pad: int, seed: int = 0):
    """A block-tridiagonal system of n_pad 6x6 blocks, the inputs of the
    interior elimination (K10b) for any partition plan of n_pad poses:
    diagonal blocks SPD with 8 on the diagonal, couplings off (n_pad - 1)
    below 0.15 in magnitude, so the whole system is diagonally dominant
    and every interior elimination step positive definite. Returns a
    dict of float64 arrays: diag, off, b."""
    rng = np.random.default_rng(seed)
    diag = rng.uniform(-0.5, 0.5, (n_pad, 6, 6))
    diag = 0.5 * (diag + diag.transpose(0, 2, 1)) + 8.0 * np.eye(6)
    off = rng.uniform(-0.15, 0.15, (n_pad - 1, 6, 6))
    return dict(diag=diag, off=off, b=rng.normal(0.0, 1.0, (n_pad, 6)))


def pko_residuals(n: int, kind: str = "wide", seed: int = 0, n_valid: int = None):
    """Signed point-to-plane-like residuals and their valid flags, the PKO
    edge cases' input: (n,) float32 and (n,) bool. kind "tight" (sigma
    0.01), "wide" (0.3) or "mixture" (3/4 inliers of sigma 0.02, 1/4 an
    outlier mode at 0.5 of sigma 0.2); about 80 % valid, or exactly n_valid
    entries at random places."""
    rng = np.random.default_rng(seed)
    if kind == "tight":
        r = rng.standard_normal(n) * 0.01
    elif kind == "wide":
        r = rng.standard_normal(n) * 0.3
    else:
        r = np.concatenate([rng.standard_normal(n * 3 // 4) * 0.02,
                            0.5 + rng.standard_normal(n - n * 3 // 4) * 0.2])
        rng.shuffle(r)
    r *= rng.choice([-1.0, 1.0], n)
    if n_valid is None:
        valid = rng.random(n) > 0.2
    else:
        valid = np.zeros(n, bool)
        valid[rng.choice(n, n_valid, replace=False)] = True
    return r.astype(np.float32), valid


def normal_eq_rows(n: int, seed: int = 0, *, g: int = None, n_valid: int = None, step=None,
                   flat_x: bool = False, nan_residual: bool = False):
    """Correspondence rows for the Gauss-Newton normal equations' edge cases
    (K2b, K11b): body points (n, 3) float32 at 1-8 m, unit normals (n, 3),
    or with flat_x normals with no x component on points 20-30 m down the
    x axis (whose H makes partial pivoting swap rows), signed residuals (n,) float32 (3/4 of
    sigma 0.02, 1/4 an outlier mode at 0.4 of sigma 0.2; or, with `step`
    (6,) = [dt | dw], exactly J step in float64 with J = [R^T n, p x R^T n],
    so that one unweighted GN step returns about -step), valid flags (n,)
    bool (about 85 %, or exactly n_valid at random places), and a pose T
    (4, 4) float32 (0.3 rad about z and a translation; the identity rotation
    with flat_x). A leading g stacks g such sets under the one pose.
    nan_residual puts NaN in the first valid row's residual."""
    rng = np.random.default_rng(seed)
    lead = () if g is None else (g,)
    d = rng.standard_normal(lead + (n, 3))
    p = (d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(1.0, 8.0, lead + (n, 1)))
    if flat_x:
        p = rng.uniform((20.0, -5.0, -2.0), (30.0, 5.0, 2.0), lead + (n, 3))
    nrm = rng.standard_normal(lead + (n, 3))
    if flat_x:
        nrm[..., 0] = 0.0
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    p = p.astype(np.float32)
    a = 0.0 if flat_x else 0.3
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]]
    T[:3, 3] = (1.3, -0.4, 0.2)
    if step is None:
        r = np.where(rng.random(lead + (n,)) < 0.75, rng.standard_normal(lead + (n,)) * 0.02,
                     0.4 + rng.standard_normal(lead + (n,)) * 0.2)
    else:
        an = nrm.astype(np.float64) @ T[:3, :3].astype(np.float64)
        J = np.concatenate([an, np.cross(p.astype(np.float64), an)], -1)
        r = J @ np.asarray(step, np.float64)
    r = r.astype(np.float32)
    if n_valid is None:
        valid = rng.random(lead + (n,)) > 0.15
    else:
        valid = np.zeros(lead + (n,), bool)
        for v in valid.reshape(-1, n):
            v[rng.choice(n, n_valid, replace=False)] = True
    if nan_residual:
        for rr, v in zip(r.reshape(-1, n), valid.reshape(-1, n)):
            rr[np.argmax(v)] = np.nan
    return p, nrm, r, valid, T


def normal_eq_shards(lanes: int, shards: int, n: int, seed: int = 0, empty: int = None):
    """K11b's edge-case input: normal_eq_rows for lanes x shards instances
    (instance g = lane * shards + k) of n rows under one pose, instance
    `empty` with no valid row, and each lane's gathered moments [sum w,
    sum |r| w, sum r^2 w] (lanes, shards, 3) float32. Returns (p, nrm, r,
    valid, T, mom)."""
    p, nrm, r, valid, T = normal_eq_rows(n, seed, g=lanes * shards)
    if empty is not None:
        valid[empty] = False
    w = valid.astype(np.float32)
    ra = np.abs(r)
    mom = np.stack([w.sum(1), (ra * w).sum(1), (ra * ra * w).sum(1)], 1)
    return p, nrm, r, valid, T, mom.reshape(lanes, shards, 3).astype(np.float32)


def surfel_blocks(children, seed: int = 0, lattice: bool = False) -> np.ndarray:
    """K4c's edge-case input: a child table (len(children) * 27 + 1, 4)
    float32 of [count | sum xyz] rows whose parent p has children[p] live
    children (the other rows and the trailing sink row zero). The children
    sit at distinct offsets among the parent's 3 x 3 x 3 cells of 0.5 m,
    parent p at (4 (p % 64), 4 (p // 64 % 64), 4 (p // 4096)) m. By default
    a child's count is 1-6 and its centroid lies near a tilted plane (1 cm
    of noise); with `lattice`, every count is 4 and every centroid its
    cell's centre, so 27 children give a covariance proportional to the
    identity (three equal eigenvalues) and 9, the middle layer, a flat
    square (the two largest equal)."""
    rng = np.random.default_rng(seed)
    children = np.asarray(children, np.int64)
    l0 = np.zeros((len(children) * 27 + 1, 4), np.float32)
    grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(27, 3)
    for p, k in enumerate(children):
        if k == 0:
            continue
        base = 4.0 * np.array([p % 64, p // 64 % 64, p // 4096], np.float64)
        if lattice:
            if k not in (9, 27):
                raise ValueError("a lattice parent has 9 or 27 children")
            offs = np.arange(27) if k == 27 else np.nonzero(grid[:, 2] == 1)[0]
            cnt = np.full(k, 4.0)
            cen = base + 0.5 * grid[offs] + 0.25
        else:
            offs = rng.choice(27, size=k, replace=False)
            cnt = rng.integers(1, 7, k).astype(np.float64)
            cen = base + 0.5 * grid[offs] + rng.uniform(0.05, 0.45, (k, 3))
            cen[:, 2] = (base[2] + 0.6 + 0.3 * (cen[:, 0] - base[0]) - 0.2 * (cen[:, 1] - base[1])
                         + rng.normal(0.0, 0.01, k))
        rows = p * 27 + offs
        l0[rows, 0] = cnt
        l0[rows, 1:] = cen * cnt[:, None]
    return l0


def shard_points(lanes: int, n: int, seed: int = 0, one_cell: bool = False,
                 masked: bool = False):
    """K11a's edge-case input: (pts (lanes, n, 3) float32, mask (lanes, n)
    bool) of points spread over a 60 m box with ~10 % masked off; with
    `one_cell` every point inside one 1.5 m parent cell (so one shard owns
    all of them), with `masked` every point masked off."""
    rng = np.random.default_rng(seed)
    if one_cell:
        pts = rng.uniform(0.1, 1.4, (lanes, n, 3)) + np.array([3.0, -6.0, 1.5])
    else:
        pts = rng.uniform(-30.0, 30.0, (lanes, n, 3)) * np.array([1.0, 1.0, 0.1])
    mask = np.zeros((lanes, n), bool) if masked else rng.random((lanes, n)) > 0.1
    return pts.astype(np.float32), mask


def knn_cloud(n: int, seed: int = 0, *, n_queries: int = 600, wide: bool = False,
              ties: bool = False, all_valid: bool = False):
    """K6b's edge-case input: (pts (n + 3, 3) float32, mask (n + 3,) bool,
    queries (n_queries + 46, 3) float32). The cloud is clustered so that 2 m
    bins hold more rows than the widest probe (16), ~10 % masked off; with
    `wide` it is 150 m wide, so a table of 0.5 m bins does not fit the dense
    128 x 128 x 32 window (the binary-search path); with `ties` every point
    and query lies on a 0.25 m lattice and a quarter of the points are
    repeated (equal squared distances across bins and within one); with
    `all_valid` no row is masked. A third of the points, in either case,
    crowd a 0.8 m Gaussian cluster. Three points stand apart: one alone 20 m
    below the cloud (its queries find fewer than 5 candidates), and two in
    the cloud's top bin, which sorts last, so that probes of a table whose
    rows are all valid clamp onto its last row. The queries: n_queries near
    the cloud's points, 3 beside each lone point, and 40 far above the cloud
    (no candidate)."""
    rng = np.random.default_rng(seed)
    if wide:
        pts = rng.uniform([-75, -20, -2], [75, 20, 3], (n, 3))
    else:
        pts = rng.uniform([-12, -12, -2], [12, 12, 4], (n, 3))
    pts[: n // 3] = rng.normal([2.0, -3.0, 0.5], 0.8, (n // 3, 3))
    if ties:
        pts = np.round(pts * 4.0) / 4.0
        rep = rng.choice(n, n // 4, replace=False)
        pts[rep] = pts[rng.choice(n, n // 4)]
    apart = np.array([[1.0, 1.0, -20.0], [3.0, 3.25, 9.5], [3.25, 3.0, 9.75]])
    pts = np.concatenate([pts, apart])
    mask = np.ones(n + 3, bool) if all_valid else rng.random(n + 3) > 0.1
    mask[n:] = True
    q = pts[rng.integers(0, n, n_queries)] + rng.normal(0.0, 0.6, (n_queries, 3))
    near = np.repeat(apart, 3, axis=0) + rng.normal(0.0, 0.3, (9, 3))
    far = rng.uniform(-5, 5, (40, 3)) + np.array([0.0, 0.0, 60.0])
    q = np.concatenate([q, near, far])
    if ties:
        q = np.round(q * 2.0) / 2.0
    return pts.astype(np.float32), mask, q[: n_queries + 46].astype(np.float32)


def plane_candidates(n: int, k: int, seed: int = 0):
    """K5b's edge-case input: (p (n, 3), cand (n, k, 3), cand_ok (n, k),
    mask (n,)), k >= 5, rows in tenths: the first tenth with exact ties
    (every odd candidate a copy of the even one before it), the second
    with fewer than 5 ok candidates, the third with all candidates on a
    line through the point (the nearest three collinear), the fourth with
    no ok candidate and masked off (an all-masked row); the rest near a
    plane (half of them flat to 1 cm) with ~70 % of the candidates ok and
    ~10 % of the rows masked off."""
    rng = np.random.default_rng(seed)
    t = max(n // 10, 1)
    p = rng.uniform(-5.0, 5.0, (n, 3))
    cand = p[:, None, :] + rng.normal(0.0, 0.4, (n, k, 3))
    flat = rng.random(n) < 0.5
    cand[flat, :, 2] = p[flat, None, 2] + rng.normal(0.0, 0.01, (int(flat.sum()), k))
    ok = rng.random((n, k)) < 0.7
    cand[:t, 1::2] = cand[:t, 0:k - 1:2][:, : k // 2]
    ok[:t, 1::2] = ok[:t, 0:k - 1:2][:, : k // 2]
    ok[t:2 * t] = False
    ok[t:2 * t, rng.integers(0, k, 3)] = True
    d = rng.normal(size=(t, 1, 3))
    s = np.linspace(0.05, 0.3, k)[None, :, None] * rng.choice([-1.0, 1.0], (t, k, 1))
    cand[2 * t:3 * t] = p[2 * t:3 * t, None, :] + d / np.linalg.norm(d, axis=-1, keepdims=True) * s
    ok[2 * t:3 * t, :5] = True
    ok[3 * t:4 * t] = False
    mask = rng.random(n) < 0.9
    mask[3 * t:4 * t] = False
    return p.astype(np.float32), cand.astype(np.float32), ok, mask


def iris_threshold_responses(b: int, x0: float, seed: int = 0, cols: int = 360):
    """K8b's edge-case input: (b, 4, 80, cols) complex64 inverse-FFT
    responses (before the x cols scale the codes undo) whose scaled squared
    magnitudes re^2 + im^2, each square and the sum rounded in float32,
    sit on and beside x0, the magnitude test's threshold: a quarter of the
    elements within 2 float32 steps of x0 (exactly on it among them), the
    rest of scaled magnitude 1e-5 to 1e-3, with random signs; ~1 % of the
    components NaN, +-inf or +-0. Returns (responses, s), s (b, 4, 80,
    cols) the float32 squared magnitudes."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    shape = (b, 4, 80, cols)
    c = f32(cols)
    mag = 10.0 ** rng.uniform(-5.0, -3.0, shape)
    ang = rng.uniform(0.0, 2.0 * np.pi, shape)
    re = (mag * np.cos(ang) / cols).astype(f32)
    im = (mag * np.sin(ang) / cols).astype(f32)
    # (re, im) pairs on and beside x0: re near sqrt(x0) / cols, im small
    r0 = np.array([np.sqrt(x0) / cols], f32).view(np.int32)[0]
    zr = (r0 + np.arange(-3000, 3000, dtype=np.int32)).view(f32)
    zi = np.concatenate([[0.0, -0.0], 10.0 ** rng.uniform(-13.0, -9.0, 254)]).astype(f32)
    R, I = np.meshgrid(zr, zi, indexing="ij")
    s = (R * c) * (R * c) + (I * c) * (I * c)
    x0_bits = int(np.array([x0], f32).view(np.int32)[0])
    near = np.abs(s.view(np.int32).astype(np.int64) - x0_bits) <= 2
    pr, pi = R[near], I[near]
    n = re.size
    at = rng.choice(n, n // 4, replace=False)
    pick = rng.integers(0, pr.size, at.size)
    sign = lambda: rng.choice(np.array([-1.0, 1.0], f32), at.size)
    re.reshape(-1)[at] = pr[pick] * sign()
    im.reshape(-1)[at] = pi[pick] * sign()
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], f32)
    for part in (re, im):
        at = rng.choice(n, n // 100, replace=False)
        part.reshape(-1)[at] = special[rng.integers(0, special.size, at.size)]
    z = np.empty(shape, np.complex64)
    z.real, z.imag = re, im
    sr, si = re * c, im * c
    return z, sr * sr + si * si


def iris_edge_clouds(b: int, n: int, seed: int = 0):
    """K8a's edge-case input: (b, n, 3) float32 sensor-frame clouds and
    (b, n) masks whose points sit on the Iris image's bin edges. Kinds, in
    about equal shares: 0 uniform within 90 m, z in [-7, 5] (past both
    ends of the ring and height bins); 1 at a range ring's edge, distance
    k in 0..85: axis-aligned points exactly on it, the others with x
    within 3 float32 steps of it; 2 with z + 5 on or within 3 float32
    steps of an integer in -1..9; 3 at a yaw column's edge (yaw + 0.5 an
    integer), x and y within 3 float32 steps of it, and the poles (y =
    +-0 with x < 0, x = +-0); and about 3 % of kind 4, a NaN or +-inf
    coordinate. About 10 % of the points are masked out. Returns (points,
    masks, kind), kind (b, n) int8."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    m = b * n
    kind = rng.integers(0, 4, m).astype(np.int8)
    kind[rng.random(m) < 0.03] = 4
    r = rng.uniform(0.0, 90.0, m)
    th = rng.uniform(-np.pi, np.pi, m)
    x, y = r * np.cos(th), r * np.sin(th)
    z = rng.uniform(-7.0, 5.0, m)
    step = lambda v, k: (np.asarray(v, f32).view(np.int32) + k).view(f32)
    jitter = lambda: rng.integers(-3, 4, m).astype(np.int32)
    # 1: on and beside the ring edges
    ring = rng.integers(0, 86, m).astype(np.float64)
    axis = rng.random(m) < 0.3
    x1 = np.where(axis, ring * rng.choice([-1.0, 1.0], m), ring * np.cos(th))
    y1 = np.where(axis, 0.0, ring * np.sin(th))
    x1 = np.where(axis, x1, step(x1, jitter()))
    # 2: on and beside the height edges
    z2 = step(rng.integers(-1, 10, m).astype(f32) - f32(5.0), jitter())
    # 3: on and beside the yaw column edges, and the +-180 degree wrap
    col = rng.integers(0, 361, m)
    a = np.radians(col - 180.5)
    x3, y3 = r * np.cos(a), r * np.sin(a)
    x3, y3 = step(x3, jitter()), step(y3, jitter())
    wrap = rng.random(m) < 0.15
    x3 = np.where(wrap, -r, x3)
    y3 = np.where(wrap, rng.choice([-0.0, 0.0], m), y3)
    pole = rng.random(m) < 0.05
    x3 = np.where(pole, rng.choice([-0.0, 0.0], m), x3)
    y3 = np.where(pole, r * rng.choice([-1.0, 1.0], m), y3)
    pts = np.stack([x, y, z], 1).astype(f32)
    k1, k2, k3, k4 = kind == 1, kind == 2, kind == 3, kind == 4
    pts[k1, 0], pts[k1, 1] = x1[k1], y1[k1]
    pts[k2, 2] = z2[k2]
    pts[k3, 0], pts[k3, 1] = x3[k3], y3[k3]
    special = np.array([np.nan, np.inf, -np.inf], f32)
    at = np.nonzero(k4)[0]
    pts[at, rng.integers(0, 3, at.size)] = special[rng.integers(0, 3, at.size)]
    masks = rng.random(m) >= 0.1
    return pts.reshape(b, n, 3), masks.reshape(b, n), kind.reshape(b, n)


def bulk_index_keys(n: int, n_buckets: int, seed: int = 0, *, n_dead: int = 0,
                    crowd: int = 0):
    """K9a's edge-case input: n distinct parent keys (hi, lo) uint32 and
    live (n,) bool, the keys of a rehash's distinct parents. n_dead of them
    (at random places) dead, holding the invalid key bits 0xFFFFFFFF;
    `crowd` live keys whose bucket among n_buckets (a power of two) is one
    bucket, so that it holds more than its 8 cells where crowd > 8; the
    rest random keys near z = 0."""
    import torch
    from ..ops.voxel_map import hash_bucket
    rng = np.random.default_rng(seed)
    seen, hi, lo = set(), [], []
    bucket = lambda h, l: hash_bucket(torch.as_tensor(h.astype(np.int64)),
                                      torch.as_tensor(l.astype(np.int64)), n_buckets - 1).numpy()

    def take(h, l):
        for a, c in zip(h.tolist(), l.tolist()):
            if (a, c) not in seen:
                seen.add((a, c))
                hi.append(a)
                lo.append(c)

    if crowd:
        target = None
        while len(hi) < crowd:
            h = (np.uint32(2 ** 31) + rng.integers(-40, 40, 65536)).astype(np.uint32)
            l = rng.integers(0, 2 ** 32, 65536, dtype=np.uint64).astype(np.uint32)
            bk = bucket(h, l)
            target = int(bk[0]) if target is None else target
            sel = bk == target
            take(h[sel][:crowd - len(hi)], l[sel][:crowd - len(hi)])
    while len(hi) < n - n_dead:
        k = n - n_dead - len(hi)
        take((np.uint32(2 ** 31) + rng.integers(-40, 40, k)).astype(np.uint32),
             rng.integers(0, 2 ** 32, k, dtype=np.uint64).astype(np.uint32))
    order = rng.permutation(n - n_dead)
    live = np.ones(n, bool)
    live[rng.choice(n, n_dead, replace=False)] = False
    key_hi = np.full(n, 0xFFFFFFFF, np.uint32)
    key_lo = np.full(n, 0xFFFFFFFF, np.uint32)
    key_hi[live] = np.asarray(hi, np.uint32)[order]
    key_lo[live] = np.asarray(lo, np.uint32)[order]
    return key_hi, key_lo, live


def merge_records(n_live: int, n_dead: int, seed: int = 0, voxel: float = 0.5):
    """K9b's edge-case input: (centroids (M, 3) f32, counts (M,) f32, live
    (M,) bool), M = n_live + n_dead records of a rehash in random order,
    n_dead of them dead. Where n_live allows, the live records hold runs of
    equal voxels: one of 60 records (longer than a 32-record tile and the 8
    records after it), then runs of 2 to 30, at the lowest z (first in key
    order, so that their parents are placed in a small map), the rest single
    records in random voxels of a 40 m cube. A record lies strictly inside
    its voxel, its count a whole number from 1 to 9."""
    rng = np.random.default_rng(seed)
    runs = []
    left = n_live
    for size in [60] + list(rng.integers(2, 31, 40)):
        if size > left:
            break
        runs.append(int(size))
        left -= size
    runs += [1] * left
    vox = np.empty((n_live, 3), np.int64)
    at = 0
    for r, size in enumerate(runs):
        if size > 1:
            v = np.array([3 * r, -3 * r, -100 - r // 8])
        else:
            v = rng.integers(-80, 80, 3)
        vox[at:at + size] = v
        at += size
    cen = ((vox + 0.1 + 0.8 * rng.random((n_live, 3))) * voxel).astype(np.float32)
    m = n_live + n_dead
    order = rng.permutation(m)
    centroids = np.zeros((m, 3), np.float32)
    counts = np.zeros(m, np.float32)
    live = np.zeros(m, bool)
    centroids[order[:n_live]] = cen
    counts[order[:n_live]] = rng.integers(1, 10, n_live).astype(np.float32)
    live[order[:n_live]] = True
    centroids[order[n_live:]] = rng.uniform(-20, 20, (n_dead, 3)).astype(np.float32)
    return centroids, counts, live


# K8c's edge cases (iris_hamming_case)
IRIS_HAMMING_CASES = ("k_1", "k_2_padded", "k_32_padded", "shifts_at_180", "shifts_across_the_wrap",
                      "candidate_is_the_query", "all_masked_candidate", "ties_across_shifts",
                      "ties_across_orientations")


def iris_hamming_case(case: str, seed: int = 0):
    """K8c's edge-case input, a DB of Iris codes and one comparison: (T, M)
    (R, 20, 360) int32 words (T random, M with ~1/8 of its bits set), the
    query row qidx, cand (K,) int32 rows, shifts (K, 2) int32 and valid
    (K,) bool. Padded slots take row 0 and are not valid, as the loop
    closure pads K to a power of two. Cases (IRIS_HAMMING_CASES): K = 1, 2
    and 32; shifts at and beside +-180; shifts whose 5-wide window crosses
    0 or a whole turn; a candidate equal to the query at a window holding
    shift 0 (distance 0); a candidate whose mask covers every bit (+inf in
    both orientations); a query and a candidate whose words are the same
    in every column (equal distances at every shift); and a candidate
    whose columns j and j + 180 are equal, with equal shifts (equal
    distances in both orientations)."""
    rng = np.random.default_rng(seed)
    words = lambda *s: rng.integers(-2 ** 31, 2 ** 31, s, dtype=np.int64).astype(np.int32)
    r = 40
    T = words(r, 20, 360)
    M = words(r, 20, 360) & words(r, 20, 360) & words(r, 20, 360)
    qidx = 3
    n, k = {"k_1": (1, 1), "k_2_padded": (1, 2), "k_32_padded": (23, 32)}.get(case, (8, 8))
    cand = np.zeros(k, np.int32)
    cand[:n] = rng.choice(np.delete(np.arange(r), qidx), n, replace=False)
    shifts = rng.integers(-180, 180, (k, 2)).astype(np.int32)
    valid = np.arange(k) < n
    if case == "shifts_at_180":
        shifts[:] = np.array([[-180, 180], [179, -179], [180, 181], [-181, -178],
                              [178, 182], [-182, 0], [0, -180], [180, 180]], np.int32)
    elif case == "shifts_across_the_wrap":
        shifts[:] = np.array([[0, 1], [-1, 2], [1, -2], [-2, 359], [360, -360],
                              [358, -358], [362, 721], [-721, 1000]], np.int32)
    elif case == "candidate_is_the_query":
        cand[:4] = qidx
        shifts[:4] = np.array([[0, 5], [2, -2], [-1, 360], [359, 179]], np.int32)
    elif case == "all_masked_candidate":
        M[cand[:3]] = -1
    elif case == "ties_across_shifts":
        for row in (qidx, *cand[:4]):
            T[row] = T[row][:, :1]
            M[row] = M[row][:, :1]
    elif case == "ties_across_orientations":
        for row in cand[:4]:
            T[row, :, 180:] = T[row, :, :180]
            M[row, :, 180:] = M[row, :, :180]
        shifts[:4, 1] = shifts[:4, 0]
    return T, M, qidx, cand, shifts, valid


# K6a's edge cases (point_grid_cloud)
POINT_GRID_CASES = ("fits", "one_bin_too_wide_x", "one_bin_too_wide_y", "one_bin_too_wide_z",
                    "no_valid_row", "one_valid_row", "rows_not_a_multiple_of_the_cta",
                    "past_one_round", "points_in_the_windows_last_bin", "duplicate_keys")


def point_grid_cloud(case: str, seed: int = 0):
    """K6a's edge-case input: (points (c, 3) float32, mask (c,) bool, bin
    size). Cases (POINT_GRID_CASES): a 0.5 m-bin cloud that fits the
    128 x 128 x 32 window; one whose bins span 129 in x, y or z (one bin too
    wide); no valid row; one valid row; 3089 rows (not a multiple of the
    kernel's 1024-thread CTA); 20000 rows (past one round of the kernel's
    16384); a cloud spanning exactly 128 x 128 x 32 bins with points in the
    window's last bin; and 2 m bins holding runs of up to 40 rows (duplicate
    keys). About 10 % of the rows are masked out, ragged-edge points among
    them."""
    rng = np.random.default_rng(seed)
    c = {"rows_not_a_multiple_of_the_cta": 3089, "past_one_round": 20000,
         "one_valid_row": 700}.get(case, 6000)
    span = np.array([40.0, 40.0, 10.0])            # metres: 80 x 80 x 20 bins of 0.5 m
    pts = rng.uniform(0.0, 1.0, (c, 3)) * span - span / 2
    bin_size = 0.5
    if case.startswith("one_bin_too_wide"):
        d = "xyz".index(case[-1])
        width = (128, 128, 32)[d] * 0.5
        pts[0, d] = -span[d] / 2
        pts[1, d] = -span[d] / 2 + width + 0.25    # bin 128 past the first row's bin
    elif case == "points_in_the_windows_last_bin":
        lo_b, hi_b = np.array([-64, -64, -16]), np.array([63, 63, 15])
        pts = rng.integers(lo_b, hi_b + 1, (c, 3)) * 0.5 + rng.uniform(0.05, 0.45, (c, 3))
        pts[:3] = lo_b * 0.5 + 0.25
        pts[3:40] = hi_b * 0.5 + rng.uniform(0.05, 0.45, (37, 3))
    elif case == "duplicate_keys":
        centres = rng.uniform(-60.0, 60.0, (c // 20, 3)) * np.array([1.0, 1.0, 0.2])
        pts = centres[rng.integers(0, len(centres), c)] + rng.uniform(-0.3, 0.3, (c, 3))
        bin_size = 2.0
    mask = rng.random(c) >= 0.1
    if case.startswith("one_bin_too_wide") or case == "points_in_the_windows_last_bin":
        mask[:40] = True
    if case == "no_valid_row":
        mask[:] = False
    elif case == "one_valid_row":
        mask[:] = False
        mask[rng.integers(0, c)] = True
    return pts.astype(np.float32), mask, bin_size
