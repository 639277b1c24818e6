"""LiDAR-Iris place-recognition descriptor (counterpart of the JAX
package's ops/iris.py: iris_image, log_gabor_filters, iris_feature,
compare_batch, compare_batch_packed).

  * the image: 80 range rings x 360 yaw columns, each pixel an 8-bit
    occupancy mask over z in [-5, 3);
  * the feature: a row FFT, 4 log-Gabor scales, the inverse FFT, binarised
    by re > 0 and im > 0 into T and by |z| < 1e-4 into the mask M, packed
    32 stacked rows a 32-bit word (held as int32: the same bits as the JAX
    uint32 words);
  * the comparison: per candidate, forward and flipped by 180 columns, a
    phase-correlation column shift, then the masked Hamming distance over
    that shift +-2; the smaller of the two, with its bias.

The FFTs are torch.fft, the shift's argmax torch.argmax (the first maximum
in row-major order, as jnp.argmax). Kernels (csrc/iris.cu), each with its
plain twin below:
  K8a iris_image — the bitmask image of a batch of clouds;
  K8g gabor_product — the row spectra times the log-Gabor filter bank,
      between the forward and inverse row FFTs;
  K8b iris_encode — the T and M codes of the inverse-FFT responses;
  K8c iris_hamming — the shifted masked Hamming search and the choice of
      orientation, reading the query and candidates from the device DB.
The shift estimate's cross-power spectrum is K7c (ops/bev_align.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels
from ..utils import keys as K
from .bev_align import cross_power

__all__ = ["iris_bits", "iris_image", "log_gabor_filters", "features", "iris_feature",
           "gabor_product", "gabor_product_plain", "iris_encode", "iris_encode_plain", "iris_hamming", "iris_hamming_plain",
           "phase_shifts", "compare_rows", "compare_batch", "compare_batch_packed", "ROWS",
           "COLS", "NSCALE", "PACKED_WORDS", "MAG_SQ_THRESHOLD", "HAMMING_SHAPE", "to_uint32"]

ROWS = 80
COLS = 360
NSCALE = 4
MIN_WAVELENGTH = 18
MULT = 2.1
SIGMA_ONF = 0.75
STACK_ROWS = 2 * NSCALE * ROWS
PACKED_WORDS = STACK_ROWS // 32  # 20
_DEG = K.f32(180.0 / math.pi)


# K8b's magnitude test |z| < 1e-4 as re^2 + im^2 < MAG_SQ_THRESHOLD: the
# least float32 x0 whose correctly rounded square root is >= 1e-4 (float32),
# bits 0x322bcc76, so that sqrt(s) < 1e-4 exactly when s < x0 for every
# float32 s (the square root is monotone; NaN compares false both ways)
MAG_SQ_THRESHOLD = float(np.uint32(0x322BCC76).view(np.float32))

# K8c's launch: a cluster of 8 CTAs x 256 threads a candidate (csrc/iris.cu
# lo_iris_hamming_shape builds the same)
HAMMING_SHAPE = {"cluster": 8, "threads": 256}


def to_uint32(words: np.ndarray) -> np.ndarray:
    """The port's int32 code words as the JAX package's uint32 words."""
    return np.asarray(words).astype(np.int32).view(np.uint32)


# ---------------------------------------------------------------------------
# K8a: the image
# ---------------------------------------------------------------------------

def iris_bits(points, mask):
    """K8a's wrapper. points (B, N, 3) f32 sensor-frame clouds, mask (B, N)
    bool. Returns (B, 80, 360) int32 pixels, bit k = height bin k occupied."""
    if not points.is_cuda:
        return _iris_bits_plain(points, mask)
    b, n = points.shape[0], points.shape[1]
    kernels.check(points, "points", torch.float32, (b, n, 3))
    kernels.check(mask, "mask", torch.bool, (b, n))
    img = torch.zeros((b, ROWS, COLS), dtype=torch.int32, device=points.device)
    kernels.KERNELS["iris_image"].launch(points.data_ptr(), mask.data_ptr(), b, n, _DEG,
                                         img.data_ptr())
    return img


def _bin(v, top: int):
    """A bin index in [0, top] from its float value as the kernel and XLA
    convert it: NaN to 0, a value past either end to that end (clamped
    before the cast, which on the CPU gives no defined result for NaN, inf
    or a value past the integer range)."""
    return torch.nan_to_num(v, nan=0.0).clamp(0, top).to(torch.int64)


def _iris_bits_plain(points, mask):
    b = points.shape[0]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    dis = torch.sqrt(x * x + y * y)
    yaw = torch.atan2(y, x) * _DEG + 180.0
    q_dis = _bin(torch.floor(dis), ROWS - 1)
    q_arc = _bin(torch.ceil(z + 5.0), 7)
    q_yaw = _bin(torch.floor(yaw + 0.5), COLS - 1)
    bi = torch.arange(b, device=points.device)[:, None].expand_as(q_dis)
    flat = ((bi * ROWS + q_dis) * COLS + q_yaw) * 8 + q_arc
    counts = torch.zeros((b * ROWS * COLS * 8,), dtype=torch.int32, device=points.device)
    counts.index_add_(0, flat.reshape(-1), mask.reshape(-1).to(torch.int32))
    bits = (counts.view(b, ROWS, COLS, 8) > 0).to(torch.int32)
    return torch.sum(bits << torch.arange(8, dtype=torch.int32, device=points.device), -1
                     ).to(torch.int32)


def iris_image(points, mask):
    """(N, 3) sensor-frame points with mask (N,) -> (80, 360) f32 occupancy
    bitmask image, values 0..255."""
    return iris_bits(points[None].contiguous(), mask[None].contiguous())[0].to(torch.float32)


# ---------------------------------------------------------------------------
# K8b: the feature codes
# ---------------------------------------------------------------------------

def log_gabor_filters() -> np.ndarray:
    """(NSCALE, COLS) real filter bank over the row frequencies; only
    0..COLS/2 are populated and index 0 is zeroed."""
    ndata = COLS
    radius = np.zeros(ndata // 2 + 1)
    radius[0] = 1.0
    radius[1:] = np.arange(1, ndata // 2 + 1) / float(ndata)
    filters = np.zeros((NSCALE, ndata), np.float32)
    wavelength = float(MIN_WAVELENGTH)
    for s in range(NSCALE):
        fo = 1.0 / wavelength
        lg = np.exp(-(np.log(radius / fo) ** 2) / (2.0 * np.log(SIGMA_ONF) ** 2))
        lg[0] = 0.0
        filters[s, : ndata // 2 + 1] = lg
        wavelength *= MULT
    return filters


def gabor_product(spec, filters):
    """K8g's wrapper: spec (B, 80, 360) complex64 row spectra, filters (4,
    360) f32. Returns (B, 4, 80, 360) complex64 spec x filter per scale."""
    if not spec.is_cuda:
        return gabor_product_plain(spec, filters)
    b = spec.shape[0]
    kernels.check(spec, "spec", torch.complex64, (b, ROWS, COLS))
    kernels.check(filters, "filters", torch.float32, (NSCALE, COLS))
    out = torch.empty((b, NSCALE, ROWS, COLS), dtype=torch.complex64, device=spec.device)
    kernels.KERNELS["gabor_product"].launch(spec.data_ptr(), filters.data_ptr(), b,
                                            out.data_ptr())
    return out


def gabor_product_plain(spec, filters):
    return spec[:, None] * filters.to(torch.complex64)[None, :, None, :]


def _responses(img, filters):
    """(B, 80, 360) f32 images -> (B, 4, 80, 360) complex64 log-Gabor
    responses, before the x COLS that undoes the inverse FFT's 1/N."""
    spec = torch.fft.fft(img.to(torch.complex64), dim=-1)
    return torch.fft.ifft(gabor_product(spec, filters.contiguous()), dim=-1)


def iris_encode(resp):
    """K8b's wrapper. resp (B, 4, 80, 360) complex64. Returns (T, M), each
    (B, 20, 360) int32 words."""
    if not resp.is_cuda:
        return iris_encode_plain(resp)
    b = resp.shape[0]
    kernels.check(resp, "resp", torch.complex64, (b, NSCALE, ROWS, COLS))
    T = torch.empty((b, PACKED_WORDS, COLS), dtype=torch.int32, device=resp.device)
    M = torch.empty((b, PACKED_WORDS, COLS), dtype=torch.int32, device=resp.device)
    kernels.KERNELS["iris_encode"].launch(resp.data_ptr(), b, float(COLS), MAG_SQ_THRESHOLD,
                                          T.data_ptr(), M.data_ptr())
    return T, M


def _pack_rows(bits):
    """(B, 640, 360) bool -> (B, 20, 360) int32 words."""
    b = bits.shape[0]
    w = bits.reshape(b, PACKED_WORDS, 32, COLS).to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)[None, None, :, None]
    return K.to_i32(torch.sum(w << shifts, 2))


def iris_encode_plain(resp):
    b = resp.shape[0]
    z = torch.view_as_real(resp) * float(COLS)
    re, im = z[..., 0], z[..., 1]
    T = torch.cat([re > 0, im > 0], 1).reshape(b, STACK_ROWS, COLS)
    # |z| < 1e-4 with a correctly rounded square root, as the squared compare
    # (torch's CPU square root is not always correctly rounded)
    m = re * re + im * im < MAG_SQ_THRESHOLD
    M = torch.cat([m, m], 1).reshape(b, STACK_ROWS, COLS)
    return _pack_rows(T), _pack_rows(M)


def features(img, filters):
    """(B, 80, 360) f32 images -> (T, M) codes, each (B, 20, 360) int32."""
    return iris_encode(_responses(img, filters).contiguous())


def iris_feature(img, filters=None):
    """(80, 360) image -> (img, T (20, 360), M (20, 360)) with int32 words."""
    if filters is None:
        filters = torch.as_tensor(log_gabor_filters(), device=img.device)
    T, M = features(img[None], filters)
    return img, T[0], M[0]


# ---------------------------------------------------------------------------
# K8c: the comparison
# ---------------------------------------------------------------------------

def phase_shifts(q_img, cand_img):
    """(K, 2) int32 column shifts of the query within each candidate image,
    forward and flipped by 180 columns: the signed column in [-180, 180) of
    each 2-D phase correlation's first maximum. q_img (80, 360), cand_img
    (K, 80, 360), both f32."""
    k = cand_img.shape[0]
    qf = torch.fft.fft2(q_img.to(torch.complex64))
    fd = torch.fft.fft2(cand_img.to(torch.complex64))
    fdx = torch.fft.fft2(torch.roll(cand_img, 180, -1).to(torch.complex64))
    cross = cross_power(fd.reshape(k, ROWS * COLS), qf.reshape(-1),
                        fdx.reshape(k, ROWS * COLS))
    corr = torch.real(torch.fft.ifft2(cross.view(2 * k, ROWS, COLS)))
    dx = torch.argmax(corr.reshape(2 * k, -1), dim=1) % COLS
    dx = torch.where(dx >= COLS // 2, dx - COLS, dx)
    return dx.view(2, k).T.contiguous().to(torch.int32)


def iris_hamming(dbT, dbM, qidx: int, cand_idx, shifts, valid):
    """K8c's wrapper. dbT, dbM (R, 20, 360) int32 code DB; the query is row
    qidx, the candidates rows cand_idx (K,) int32; shifts (K, 2) int32;
    valid (K,) bool. Returns (K, 2) f32 [distance | bias], +inf distance
    where not valid. The kernel runs a cluster of HAMMING_SHAPE a
    candidate."""
    if not dbT.is_cuda:
        return iris_hamming_plain(dbT, dbM, qidx, cand_idx, shifts, valid)
    r, k = dbT.shape[0], cand_idx.shape[0]
    kernels.check(dbT, "dbT", torch.int32, (r, PACKED_WORDS, COLS))
    kernels.check(dbM, "dbM", torch.int32, (r, PACKED_WORDS, COLS))
    kernels.check_aligned(dbT, "dbT")
    kernels.check_aligned(dbM, "dbM")
    kernels.check(cand_idx, "cand_idx", torch.int32, (k,))
    kernels.check(shifts, "shifts", torch.int32, (k, 2))
    kernels.check(valid, "valid", torch.bool, (k,))
    if not 0 <= qidx < r:
        raise ValueError(f"iris_hamming: query row {qidx} outside the DB's {r} rows")
    out = torch.empty((k, 2), dtype=torch.float32, device=dbT.device)
    if k:
        kernels.KERNELS["iris_hamming"].launch(
            dbT.data_ptr(), dbM.data_ptr(), int(qidx), cand_idx.data_ptr(), shifts.data_ptr(),
            valid.data_ptr(), k, out.data_ptr())
    return out


def _popcount(x):
    """Per-element popcount of int32 words (SWAR, in int64)."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return ((u * 0x01010101) & 0xFFFFFFFF) >> 24


def _hamming_over_shifts(qT, qM, dT, dM, s0):
    """(K,) distance and shift minimised over s0 + [-2, 2] (first minimum)."""
    dists, shifts = [], []
    for off in range(-2, 3):
        s = s0 + off
        cols = torch.remainder(torch.arange(COLS, device=qT.device)[None, :] - s[:, None], COLS)
        idx = cols[:, None, :].expand(-1, PACKED_WORDS, -1)
        T1 = torch.gather(qT[None].expand(len(s), -1, -1), 2, idx)
        M1 = torch.gather(qM[None].expand(len(s), -1, -1), 2, idx)
        mk = M1 | dM
        total = STACK_ROWS * COLS - _popcount(mk).sum((1, 2))
        diff = _popcount((T1 ^ dT) & ~mk).sum((1, 2))
        dis = diff.to(torch.float32) / torch.clamp(total, min=1).to(torch.float32)
        dists.append(torch.where(total == 0, torch.inf, dis))
        shifts.append(s)
    dists, shifts = torch.stack(dists, 1), torch.stack(shifts, 1)
    best = torch.argmin(dists, 1, keepdim=True)
    return torch.gather(dists, 1, best)[:, 0], torch.gather(shifts, 1, best)[:, 0]


def iris_hamming_plain(dbT, dbM, qidx: int, cand_idx, shifts, valid):
    ci = cand_idx.to(torch.int64)
    qT, qM, dT, dM = dbT[qidx], dbM[qidx], dbT[ci], dbM[ci]
    sh = shifts.to(torch.int64)
    d1, b1 = _hamming_over_shifts(qT, qM, dT, dM, sh[:, 0])
    d2, b2 = _hamming_over_shifts(qT, qM, torch.roll(dT, 180, -1), torch.roll(dM, 180, -1),
                                  sh[:, 1])
    use1 = d1 < d2
    dist = torch.where(valid, torch.where(use1, d1, d2), torch.inf)
    bias = torch.where(use1, b1, torch.remainder(b2 + 180, 360))
    return torch.stack([dist, bias.to(torch.float32)], 1)


def compare_rows(db_img, dbT, dbM, qidx: int, cand_idx, valid):
    """Compare DB row qidx against DB rows cand_idx (K,) int32, all on the
    device: the phase-correlation shifts (torch.fft) and K8c. Returns (K, 2)
    f32 [distance | bias]."""
    ci = cand_idx.to(torch.int64)
    shifts = phase_shifts(db_img[qidx].to(torch.float32), db_img[ci].to(torch.float32))
    return iris_hamming(dbT, dbM, qidx, cand_idx, shifts, valid)


def compare_batch_packed(q_img, qT, qM, db_img, dbT, dbM, db_valid):
    """One query feature against a batch: q_img (80, 360) f32, qT/qM (20,
    360) int32, db_* (K, ...). Returns (K, 2) f32 [distance | bias]; +inf
    distance where not valid. The JAX package's signature, kept for callers
    and parity tests of that API; the estimator compares DB rows in place
    through compare_rows."""
    k = db_img.shape[0]
    img = torch.cat([q_img[None], db_img.to(torch.float32)])
    T = torch.cat([qT[None], dbT]).contiguous()
    M = torch.cat([qM[None], dbM]).contiguous()
    idx = torch.arange(1, k + 1, dtype=torch.int32, device=q_img.device)
    return compare_rows(img, T, M, 0, idx, db_valid)


def compare_batch(q_img, qT, qM, db_img, dbT, dbM, db_valid):
    """compare_batch_packed as (distances (K,), biases (K,) int32), the JAX
    package's compare_batch."""
    out = compare_batch_packed(q_img, qT, qM, db_img, dbT, dbM, db_valid)
    return out[:, 0], out[:, 1].to(torch.int32)
