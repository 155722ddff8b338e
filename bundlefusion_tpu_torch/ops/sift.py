"""SIFT-style keypoint detection + 128-d descriptors.

Port of ``bundlefusion_tpu/ops/sift.py`` (behavioural equivalent of the
reference's SiftGPU subsystem: BuildPyramid -> DetectKeypoints ->
LimitFeatureCount -> GetFeatureOrientations -> GetFeatureDescriptors, plus
the per-key depth attach and range rejection).

Everything is fixed-shape, as in the reference port: a fixed candidate
capacity per octave, the top ``target_keys`` by DoG response, validity
masks. What differs is the idiom. The JAX code spells each blur and each
neighbourhood test as a sum of shifted images, which suits a TPU's vector
unit; here a blur is two ``conv2d`` calls on an edge-padded image and the
26-neighbour extremum test is a few running maxima over the whole DoG
stack, so an octave is tens of calls instead of hundreds. Histograms are
one-hot contractions (not scatter-adds), which makes the descriptors
bitwise repeatable on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from bundlefusion_tpu_torch.utils.timing import stage


@dataclass(frozen=True)
class SiftConfig:
    num_octaves: int = 4
    scales_per_octave: int = 3
    sigma0: float = 1.6
    dog_thresh: float = 0.0066        # ~= SiftGPU default 0.02/3 on [0,1] intensity
    edge_thresh: float = 10.0
    max_candidates_per_octave: int = 512
    max_keys: int = 1024              # s_maxNumKeysPerImage
    target_keys: int = 150            # featureCountThreshold (Bundler.cpp:61)
    min_scale: float = 3.0            # s_minKeyScale
    depth_min: float = 0.1
    depth_max: float = 4.0


class SiftKeypoints(NamedTuple):
    """Fixed-capacity keypoint set for one image (pos in full-res pixels)."""

    pos: torch.Tensor          # [K, 2] (x, y)
    scale: torch.Tensor        # [K]
    orientation: torch.Tensor  # [K] radians
    response: torch.Tensor     # [K]
    depth: torch.Tensor        # [K]
    valid: torch.Tensor        # [K] bool
    desc: torch.Tensor         # [K, 128] unit-normalized float32


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


@lru_cache(maxsize=16)
def _blur_taps(cfg: SiftConfig, device: torch.device):
    """The pyramid's blur kernels as tensors on ``device``, [octave][level]:
    uploaded once per configuration, not once per frame."""
    S = cfg.scales_per_octave
    taps = []
    for o in range(cfg.num_octaves):
        sigma_prev = 0.5 if o == 0 else cfg.sigma0
        row = []
        # level sigmas within octave: sigma0 * 2^(s/S)
        for s in range(S + 3):
            sigma_target = cfg.sigma0 * (2.0 ** (s / S))
            add = float(np.sqrt(max(sigma_target**2 - sigma_prev**2, 0.01)))
            row.append(torch.as_tensor(_gauss_kernel1d(add), device=device))
            sigma_prev = sigma_target
        taps.append(row)
    return taps


def _sep_conv(img: torch.Tensor, k) -> torch.Tensor:
    """Separable 2D blur of [H, W] by the 1D kernel ``k`` with edge-clamp
    padding: along the rows first, then along the columns."""
    kt = torch.as_tensor(k, dtype=img.dtype, device=img.device)
    r = (kt.shape[0] - 1) // 2
    x = img[None, None]
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), kt.reshape(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), kt.reshape(1, 1, -1, 1))
    return x[0, 0]


def build_pyramid(intensity: torch.Tensor, cfg: SiftConfig):
    """Gaussian + DoG pyramid: per octave a dict with ``gauss`` [S+3, h, w]
    and ``dog`` [S+2, h, w]."""
    S = cfg.scales_per_octave
    octaves = []
    base = intensity
    for taps in _blur_taps(cfg, intensity.device):
        levels = []
        img = base
        for k in taps:
            img = _sep_conv(img, k)
            levels.append(img)
        gauss = torch.stack(levels)
        octaves.append({"gauss": gauss, "dog": gauss[1:] - gauss[:-1]})
        # next octave: downsample level S (sigma = 2*sigma0)
        base = levels[S][::2, ::2]
    return octaves


def _roll(x, dy, dx):
    return torch.roll(x, (dy, dx), (-2, -1))


def _neighbour_extrema(x: torch.Tensor, largest: bool):
    """For a stack [L, H, W]: (extremum of each pixel's 8 in-plane
    neighbours, extremum of its full 3x3 window), wrapping like
    ``jnp.roll``. The centre is kept out of the first so a strict test
    against it stays strict when a neighbour ties."""
    ext = torch.maximum if largest else torch.minimum
    sides = ext(_roll(x, 0, 1), _roll(x, 0, -1))
    row3 = ext(sides, x)
    rows = ext(_roll(row3, 1, 0), _roll(row3, -1, 0))
    return ext(sides, rows), ext(row3, rows)


def _detect_octave(dog: torch.Tensor, cfg: SiftConfig, octave: int):
    """Local 3D extrema of one octave's DoG stack [S+2, H, W].

    Returns fixed-cap candidates (x [C], y [C] in octave pixels, scale index
    [C], response [C], valid [C]), strongest first (exact top-k)."""
    S = cfg.scales_per_octave
    Hh, Ww = dog.shape[1:]
    center = dog[1 : S + 1]
    # strict 26-neighbour test: the 8 in-plane neighbours and the 3x3
    # windows of the scales below and above
    hi8, hi9 = _neighbour_extrema(dog, True)
    lo8, lo9 = _neighbour_extrema(dog, False)
    hi = torch.maximum(hi8[1 : S + 1], torch.maximum(hi9[:S], hi9[2 : S + 2]))
    lo = torch.minimum(lo8[1 : S + 1], torch.minimum(lo9[:S], lo9[2 : S + 2]))
    extremum = ((center > hi) | (center < lo)) & (torch.abs(center) > cfg.dog_thresh)
    # edge rejection via 2x2 spatial Hessian
    dxx = _roll(center, 0, -1) + _roll(center, 0, 1) - 2 * center
    dyy = _roll(center, -1, 0) + _roll(center, 1, 0) - 2 * center
    dxy = 0.25 * (
        _roll(center, -1, -1) + _roll(center, 1, 1) - _roll(center, -1, 1) - _roll(center, 1, -1)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = cfg.edge_thresh
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) * (r + 1) * det)
    ok = extremum & edge_ok
    # border exclusion (also hides every wrapped neighbour above)
    ok[:, :2] = False
    ok[:, -2:] = False
    ok[:, :, :2] = False
    ok[:, :, -2:] = False
    resp = torch.where(ok, torch.abs(center), 0.0)            # [S, H, W]
    top_resp, top_idx = torch.topk(resp.reshape(-1), cfg.max_candidates_per_octave)
    s_idx = top_idx // (Hh * Ww) + 1
    rem = top_idx % (Hh * Ww)
    yy = rem // Ww
    xx = rem % Ww
    return xx.to(torch.float32), yy.to(torch.float32), s_idx, top_resp, top_resp > 0


# 16x16 sample grid offsets for orientation/descriptor windows, [256, 2] in
# units of "descriptor cells / 4"
_GRID = np.stack(
    np.meshgrid(np.arange(16) - 7.5, np.arange(16) - 7.5, indexing="xy"), -1
).reshape(-1, 2).astype(np.float32)


@lru_cache(maxsize=4)
def _grid(device: torch.device):
    g = torch.as_tensor(_GRID, device=device)
    return g[None, :, 0], g[None, :, 1]


def _bilinear_flat(flat, base, W, H, x, y):
    """Bilinear sample from a flattened image bank: ``flat`` [total] is the
    concatenation of all (octave, level) images, ``base`` / ``W`` / ``H``
    the per-sample image offset and size, ``x`` / ``y`` float coords.
    Clamps at the image borders."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.minimum(torch.clamp(x0.to(torch.int64), min=0), W - 1)
    y0i = torch.minimum(torch.clamp(y0.to(torch.int64), min=0), H - 1)
    x1i = torch.minimum(x0i + 1, W - 1)
    y1i = torch.minimum(y0i + 1, H - 1)
    last = flat.shape[0] - 1

    def take(idx):
        return flat[torch.clamp(idx, 0, last)]

    a = take(base + y0i * W + x0i)
    b = take(base + y0i * W + x1i)
    c = take(base + y1i * W + x0i)
    d = take(base + y1i * W + x1i)
    return a * (1 - fx) * (1 - fy) + b * fx * (1 - fy) + c * (1 - fx) * fy + d * fx * fy


def _histogram(weights: torch.Tensor, bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[K, s] weights into [K, n_bins] by a one-hot contraction: the same
    sums as a scatter-add, in an order that does not change from run to
    run (float atomics on the card do)."""
    onehot = F.one_hot(bins, n_bins).to(weights.dtype)        # [K, s, n_bins]
    return (weights[:, None, :] @ onehot)[:, 0]


def _orientations(gm_flat, go_flat, base, W, H, x, y, sigma_local):
    """Dominant gradient orientations for all keys at once (reference
    ``ComputeOrientation_Kernel``). All args [K] except the flat banks;
    returns [K] angles."""
    grid_x, grid_y = _grid(x.device)
    scale = (1.5 * sigma_local / 4.0 * 2.0)[:, None]          # [K, 1]
    offx = grid_x * scale                                      # [K, 256]
    offy = grid_y * scale
    # the sample point with one rounding, as the reference's compiler
    # fuses x + grid * scale into a multiply-add (exact in float64, then
    # rounded once): outside the image the clamped bilinear read jumps a
    # whole pixel at an integer, and a grid point that rounds onto one on
    # one side and an ulp past it on the other turns the key
    sx = (x.double()[:, None] + grid_x.double() * scale.double()).float()
    sy = (y.double()[:, None] + grid_y.double() * scale.double()).float()
    m = _bilinear_flat(gm_flat, base[:, None], W[:, None], H[:, None], sx, sy)
    o = _bilinear_flat(go_flat, base[:, None], W[:, None], H[:, None], sx, sy)
    r2 = offx * offx + offy * offy
    sig_w = (1.5 * sigma_local)[:, None]
    w = m * torch.exp(-r2 / (2 * sig_w * sig_w * 4.0))
    bins = torch.floor(o / (2 * math.pi) * 36.0).to(torch.int64) % 36
    hist = _histogram(w, bins, 36)                             # [K, 36]
    for _ in range(2):  # smooth (2 passes of [1,1,1]/3)
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    b = torch.argmax(hist, dim=1)                              # [K]
    h0 = hist.gather(1, ((b - 1) % 36)[:, None])[:, 0]
    h1 = hist.gather(1, b[:, None])[:, 0]
    h2 = hist.gather(1, ((b + 1) % 36)[:, None])[:, 0]
    denom = h0 - 2 * h1 + h2
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (h0 - h2) / denom, 0.0)
    return (b.to(torch.float32) + 0.5 + delta) * (2 * math.pi / 36.0)


@lru_cache(maxsize=4)
def _spatial_bins(device: torch.device) -> torch.Tensor:
    """The descriptor's bilinear spatial binning, which no key changes:
    [16, 256] weights of each of the 256 grid samples in each of the 4x4
    cells (up to four cells per sample; a sample's share that falls outside
    the 4x4 grid is dropped)."""
    bx = (_GRID[:, 0] + 7.5) / 4.0
    by = (_GRID[:, 1] + 7.5) / 4.0
    bx0 = np.floor(bx - 0.5)
    by0 = np.floor(by - 0.5)
    fx = bx - 0.5 - bx0
    fy = by - 0.5 - by0
    cells = np.zeros((16, 256), np.float32)
    for dx_ in (0, 1):
        for dy_ in (0, 1):
            ix = (bx0 + dx_).astype(np.int64)
            iy = (by0 + dy_).astype(np.int64)
            inb = (ix >= 0) & (ix < 4) & (iy >= 0) & (iy < 4)
            wgt = (fx if dx_ else 1 - fx) * (fy if dy_ else 1 - fy)
            s = np.nonzero(inb)[0]
            cells[iy[s] * 4 + ix[s], s] += wgt[s]
    return torch.as_tensor(cells, device=device)


def _descriptors(gm_flat, go_flat, base, W, H, x, y, sigma_local, ang):
    """4x4x8 SIFT descriptors for all keys at once (reference
    ``ComputeDescriptor_Kernel`` + ``NormalizeDescriptor``). Returns [K, 128].

    Trilinear binning: the spatial part is the constant ``_spatial_bins``,
    the orientation part two one-hot rows per sample; their product summed
    over the samples is one batched matrix product."""
    grid_x, grid_y = _grid(x.device)
    cell = (3.0 * sigma_local / 4.0)[:, None]                  # [K, 1]
    ca = torch.cos(ang)[:, None]
    sa = torch.sin(ang)[:, None]
    gx = grid_x * cell
    gy = grid_y * cell
    sx = x[:, None] + ca * gx - sa * gy
    sy = y[:, None] + sa * gx + ca * gy
    m = _bilinear_flat(gm_flat, base[:, None], W[:, None], H[:, None], sx, sy)
    o = _bilinear_flat(go_flat, base[:, None], W[:, None], H[:, None], sx, sy) - ang[:, None]
    w = m * torch.exp(-(grid_x**2 + grid_y**2) / (2 * 8.0 * 8.0))   # [K, 256]
    bo = torch.remainder(o / (2 * math.pi), 1.0) * 8.0
    bo0 = torch.floor(bo)
    fo = (bo - bo0)[..., None]
    io = bo0.to(torch.int64)
    # [K, 256, 8]: each sample's weight split between its two orientation bins
    split = F.one_hot(io % 8, 8) * (1 - fo) + F.one_hot((io + 1) % 8, 8) * fo
    desc = ((_spatial_bins(x.device) * w[:, None, :]) @ split).reshape(-1, 128)
    d = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-12)
    d = torch.clamp(d, max=0.2)
    return d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True), min=1e-12)


@lru_cache(maxsize=16)
def _bank_layout(shapes: tuple, S: int, device: torch.device):
    """Where each (octave, level 1..S) image starts in the flat gradient
    bank: (base [O * (S+1)] flat offsets, W [O], H [O]) on ``device``."""
    base = np.zeros((len(shapes), S + 1), np.int64)
    off = 0
    for o, (Ho, Wo) in enumerate(shapes):
        for s in range(1, S + 1):
            base[o, s] = off
            off += Ho * Wo
    return (torch.as_tensor(base.reshape(-1), device=device),
            torch.as_tensor([w for _, w in shapes], device=device),
            torch.as_tensor([h for h, _ in shapes], device=device))


def _gradient_bank(octaves, cfg: SiftConfig):
    """Gradient magnitude / orientation of every (octave, level 1..S) image,
    flattened and concatenated so each key samples its own level in one
    pass. Returns (gm_flat, go_flat) laid out as ``_bank_layout`` says."""
    S = cfg.scales_per_octave
    gm_parts, go_parts = [], []
    for pyr in octaves:
        g = pyr["gauss"][1 : S + 1]                            # [S, Ho, Wo]
        # central differences; the edge columns / rows wrap like jnp.roll
        dgx = 0.5 * (_roll(g, 0, -1) - _roll(g, 0, 1))
        dgy = 0.5 * (_roll(g, -1, 0) - _roll(g, 1, 0))
        gm_parts.append(torch.sqrt(dgx * dgx + dgy * dgy).reshape(-1))
        go_parts.append(torch.remainder(torch.atan2(dgy, dgx), 2 * math.pi).reshape(-1))
    return torch.cat(gm_parts), torch.cat(go_parts)


def detect_and_describe(intensity: torch.Tensor, depth: torch.Tensor,
                        cfg: SiftConfig = SiftConfig(), timing=None) -> SiftKeypoints:
    """Full detection pipeline on one frame.

    Args:
      intensity: [H, W] float32 in [0, 1] (at SIFT resolution, e.g. 640x480).
      depth: [H, W] float32 aligned depth for the per-key depth attach and
        range rejection.
      timing: optional ``TimingLog``; the pyramid, the detection and the
        orientation + descriptor stage are recorded apart.
    """
    S = cfg.scales_per_octave
    dev = intensity.device
    with stage(timing, "time_sift_pyramid"):
        octaves = build_pyramid(intensity, cfg)

    with stage(timing, "time_sift_detect"):
        xs, ys, scales, resps, valids, octs, sidxs = [], [], [], [], [], [], []
        for o, pyr in enumerate(octaves):
            xx, yy, sidx, resp, valid = _detect_octave(pyr["dog"], cfg, o)
            mul = float(2**o)
            xs.append(xx * mul)
            ys.append(yy * mul)
            scales.append(cfg.sigma0 * torch.exp2(sidx.to(torch.float32) / S) * mul)
            resps.append(resp)
            valids.append(valid)
            octs.append(torch.full_like(sidx, o))
            sidxs.append(sidx)
        x = torch.cat(xs)
        y = torch.cat(ys)
        scale = torch.cat(scales)
        resp = torch.cat(resps)
        valid = torch.cat(valids)
        oct_idx = torch.cat(octs)
        s_idx = torch.cat(sidxs)

        # depth attach + rejection at full-res coords
        H, W = depth.shape
        xi = torch.clamp(torch.round(x).to(torch.int64), 0, W - 1)
        yi = torch.clamp(torch.round(y).to(torch.int64), 0, H - 1)
        d = depth.reshape(-1)[yi * W + xi]
        depth_ok = torch.isfinite(d) & (d >= cfg.depth_min) & (d <= cfg.depth_max)
        valid = valid & depth_ok & (scale >= cfg.min_scale)

        # keep top target_keys by response
        score = torch.where(valid, resp, -1.0)
        top_score, top_i = torch.topk(score, cfg.target_keys)
        kx = x[top_i]
        ky = y[top_i]
        kvalid = top_score > 0
        koct = oct_idx[top_i]
        ksidx = s_idx[top_i]

    with stage(timing, "time_sift_describe"):
        gm_flat, go_flat = _gradient_bank(octaves, cfg)
        shapes = tuple(tuple(pyr["gauss"].shape[1:]) for pyr in octaves)
        base_all, W_all, H_all = _bank_layout(shapes, S, dev)
        base = base_all[koct * (S + 1) + ksidx]
        Wk = W_all[koct]
        Hk = H_all[koct]
        mulk = torch.exp2(koct.to(torch.float32))
        lx = kx / mulk
        ly = ky / mulk
        sig_local = cfg.sigma0 * torch.exp2(ksidx.to(torch.float32) / S)
        ang = _orientations(gm_flat, go_flat, base, Wk, Hk, lx, ly, sig_local)
        desc = _descriptors(gm_flat, go_flat, base, Wk, Hk, lx, ly, sig_local, ang)
        desc = torch.where(kvalid[:, None], desc, 0.0)

    return SiftKeypoints(
        pos=torch.stack([kx, ky], -1),
        scale=scale[top_i],
        orientation=ang,
        response=resp[top_i],
        depth=d[top_i],
        valid=kvalid,
        desc=desc,
    )
