"""Hand-written CUDA kernels: lazy build, load and launch wrappers.

Each ``*.cu`` source here has a plain C interface. On first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``kernels/build/`` (listed in ``.gitignore``) and loaded with ``ctypes``;
the library's name carries a hash of the source and flags, so an edited
source is rebuilt. Nothing is built or loaded when this module is
imported, and there is no fallback: a missing ``nvcc``, a failed build or
a refused launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "build")
SOURCES = {
    "tsdf_prepare": "tsdf_prepare.cu",  # image pass: one float4 sample per pixel
    "tsdf_cull": "tsdf_cull.cu",        # frustum cull into a device-side row list
    "tsdf_apply": "tsdf_apply.cu",      # the integrate / de-integrate sweep
    "kabsch_filter": "kabsch_filter.cu",  # the greedy Kabsch filter, one warp per pair
    "surface_area": "surface_area.cu",    # the surface-area filter, one warp per pair
}
MAX_OPS = 64  # ops per call: one bit each in a row's op mask
KABSCH_MAX_R = 1024  # raw matches per pair: at most 32 in each lane of its warp
SURFACE_AREA_MAX_R = 1024  # matches per pair of the surface-area kernel
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no multiply-add contraction and IEEE division / sqrt: the kernels
    # must round exactly like their plain PyTorch versions
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}  # name -> nvcc output (ptxas register / spill report)
launch_counts = {name: 0 for name in SOURCES}  # +1 per kernel launch


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def _lib_path(name: str) -> str:
    src = os.path.join(KERNEL_DIR, SOURCES[name])
    with open(src, "rb") as fh:
        h = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{h}.so")


def build_all(names=None) -> dict:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns {name: library path}."""
    names = list(names or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(KERNEL_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)
    return {name: _lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "tsdf_prepare":
        lib.bf_tsdf_prepare.restype = I
        lib.bf_tsdf_prepare.argtypes = [P] * 4 + [I] * 2 + [P]
    elif name == "tsdf_cull":
        lib.bf_tsdf_cull.restype = I
        lib.bf_tsdf_cull.argtypes = [P] * 8 + [I] * 5 + [F] * 8 + [P]
    elif name == "tsdf_apply":
        lib.bf_tsdf_apply.restype = I
        lib.bf_tsdf_apply.argtypes = [P] * 11 + [I] * 5 + [F] * 12 + [P]
        lib.bf_tsdf_apply_wave.restype = I
        lib.bf_tsdf_apply_wave.argtypes = []
    elif name == "kabsch_filter":
        lib.bf_kabsch_filter.restype = I
        lib.bf_kabsch_filter.argtypes = [P] * 9 + [I] * 4 + [F] + [P]
    elif name == "surface_area":
        lib.bf_surface_area.restype = I
        lib.bf_surface_area.argtypes = [P] * 6 + [I] * 2 + [F] + [P]


def _check_cuda(t: torch.Tensor, dtype, what: str, shape=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{what}: need a CUDA {dtype} tensor, got {type(t).__name__}")
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous CUDA {dtype} tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_op_table(signs, imgs, ops: int) -> None:
    """The op table the TSDF kernels read on the card: ``signs`` float32
    [OPS] and ``imgs`` int32 [OPS]. Its values are not read here: an op
    whose image index is out of range is skipped on the card."""
    if not 0 < ops <= MAX_OPS:
        raise ValueError(f"need 1..{MAX_OPS} ops, got {ops}")
    _check_cuda(signs, torch.float32, "signs", (ops,))
    _check_cuda(imgs, torch.int32, "imgs", (ops,))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def tsdf_prepare_launch(depths, colors):
    """Launch ``tsdf_prepare.cu``: ``depths`` [IMGS, H, W] and ``colors``
    [IMGS, H, W, 3] -> the quantised samples ``packed`` [IMGS, H, W, 4]
    (``d_q, r_q, g_q, b_q`` per pixel) and each image's largest sampled
    depth ``img_dmax`` [IMGS]."""
    lib = load("tsdf_prepare")
    _check_cuda(depths, torch.float32, "depths")
    imgs, H, W = depths.shape
    _check_cuda(colors, torch.float32, "colors", (imgs, H, W, 3))
    packed = torch.empty((imgs, H, W, 4), dtype=torch.float32, device=depths.device)
    img_dmax = torch.empty((imgs,), dtype=torch.float32, device=depths.device)
    if packed.data_ptr() % 16:
        raise ValueError("tsdf_prepare: the sample buffer is not 16-byte aligned")
    _raise_on(lib.bf_tsdf_prepare(
        depths.data_ptr(), colors.data_ptr(), packed.data_ptr(), img_dmax.data_ptr(),
        int(imgs), int(H * W), _stream(depths)), "tsdf_prepare")
    launch_counts["tsdf_prepare"] += 1
    return packed, img_dmax


def tsdf_cull_launch(table, w2c, signs, imgs, img_dmax, intr, params, H, W):
    """Launch ``tsdf_cull.cu`` over every payload row of ``table``.

    ``w2c`` [OPS, 3, 4] world-to-camera rows per op; ``signs`` float32 /
    ``imgs`` int32 [OPS] the op table, on the card; ``img_dmax`` [IMGS] from
    the image pass. Nothing is read back. Returns ``rows``
    int32 [N] and ``masks`` int64 [N], of which the first ``n_rows`` (an
    int32 tensor [1], on the card) entries are the listed rows, in no
    fixed order, and the bit masks of the ops that can touch each."""
    lib = load("tsdf_cull")
    ops = w2c.shape[0]
    n = table.num_blocks
    _check_cuda(table.slot_keys, torch.int32, "slot_keys")
    _check_cuda(w2c, torch.float32, "w2c", (ops, 3, 4))
    _check_cuda(img_dmax, torch.float32, "img_dmax")
    _check_op_table(signs, imgs, ops)
    dev = table.slot_keys.device
    rows = torch.empty((n,), dtype=torch.int32, device=dev)
    masks = torch.empty((n,), dtype=torch.int64, device=dev)
    n_rows = torch.empty((1,), dtype=torch.int32, device=dev)
    _raise_on(lib.bf_tsdf_cull(
        table.slot_keys.data_ptr(), w2c.data_ptr(), img_dmax.data_ptr(),
        signs.data_ptr(), imgs.data_ptr(), rows.data_ptr(), masks.data_ptr(),
        n_rows.data_ptr(), int(n), int(ops), int(img_dmax.shape[0]), int(H), int(W),
        intr.fx, intr.fy, intr.cx, intr.cy, 8 * params.voxel_size,
        params.truncation, params.truncation_scale,
        min(params.depth_max, params.max_integration_distance),
        _stream(rows)), "tsdf_cull")
    launch_counts["tsdf_cull"] += 1
    return rows, masks, n_rows


def tsdf_apply_launch(table, rows, masks, n_rows, packed, w2c, signs, imgs, intr, params,
                      grid_ctas: int = 0) -> None:
    """Launch ``tsdf_apply.cu`` over the first ``n_rows`` (read on the
    card) payload rows listed in ``rows`` of ``table`` (in place), applying
    to each row the ops whose bit its mask holds, in array order.

    ``packed`` [IMGS, H, W, 4] are the image pass's samples, ``w2c``
    [OPS, 3, 4] the world-to-camera rows, ``signs`` float32 / ``imgs`` int32
    [OPS] the op table, on the card. ``grid_ctas`` sets the size of the
    persistent grid; 0 takes as many CTAs as the card holds at once."""
    lib = load("tsdf_apply")
    ops = w2c.shape[0]
    for t, dt, what in (
        (table.sdf, torch.float32, "sdf"), (table.weight, torch.float32, "weight"),
        (table.color, torch.float32, "color"), (rows, torch.int32, "rows"),
        (masks, torch.int64, "masks"), (n_rows, torch.int32, "n_rows"),
        (table.slot_keys, torch.int32, "slot_keys"), (packed, torch.float32, "packed"),
    ):
        _check_cuda(t, dt, what)
    _check_cuda(w2c, torch.float32, "w2c", (ops, 3, 4))
    if packed.dim() != 4 or packed.shape[3] != 4 or packed.data_ptr() % 16:
        raise ValueError("tsdf_apply: samples must be [IMGS, H, W, 4], 16-byte aligned")
    if table.sdf.shape[1] != 512 or table.color.shape[1] != 1536:
        raise ValueError("tsdf_apply: payload rows must be 512 / 1536 wide")
    if masks.shape[0] < rows.shape[0] or n_rows.numel() != 1:
        raise ValueError("tsdf_apply: one mask per listed row and one row count")
    _check_op_table(signs, imgs, ops)
    n_imgs, H, W, _ = packed.shape
    _raise_on(lib.bf_tsdf_apply(
        table.sdf.data_ptr(), table.weight.data_ptr(), table.color.data_ptr(),
        rows.data_ptr(), masks.data_ptr(), n_rows.data_ptr(),
        table.slot_keys.data_ptr(), packed.data_ptr(), w2c.data_ptr(), signs.data_ptr(),
        imgs.data_ptr(), int(ops), int(n_imgs), int(H), int(W), int(grid_ctas),
        intr.fx, intr.fy, intr.cx, intr.cy, params.voxel_size,
        8 * params.voxel_size, params.truncation, params.truncation_scale,
        params.depth_min, min(params.depth_max, params.max_integration_distance),
        params.integration_weight_sample, params.integration_weight_max,
        _stream(rows)), "tsdf_apply")
    launch_counts["tsdf_apply"] += 1


def tsdf_apply_wave() -> int:
    """CTAs of the sweep kernel that the current card holds at once: the
    default size of its persistent grid."""
    return int(load("tsdf_apply").bf_tsdf_apply_wave())


def kabsch_filter_launch(src_pts, tgt_pts, pix_src, pix_tgt, valid, max_filtered: int,
                         min_num_matches: int, max_res2: float):
    """Launch ``kabsch_filter.cu``: the greedy Kabsch filter of P image
    pairs, one warp each, on the current stream.

    ``src_pts`` / ``tgt_pts`` [P, R, 3] and ``pix_src`` / ``pix_tgt``
    [P, R, 2] float32, ``valid`` [P, R] bool (a prefix per pair), R at most
    ``KABSCH_MAX_R``. Returns ``inlier_mask`` [P, R] bool, ``count`` [P]
    int64, ``transform`` [P, 4, 4] float32 (src -> tgt) and ``valid_pair``
    [P] bool, all on the card. Nothing is read back; P = 0 launches
    nothing."""
    _check_cuda(valid, torch.bool, "valid")
    if valid.dim() != 2:
        raise ValueError(f"valid: need [P, R], got {tuple(valid.shape)}")
    P, R = valid.shape
    for t, what, k in ((src_pts, "src_pts", 3), (tgt_pts, "tgt_pts", 3),
                       (pix_src, "pix_src", 2), (pix_tgt, "pix_tgt", 2)):
        _check_cuda(t, torch.float32, what, (P, R, k))
    if R > KABSCH_MAX_R:
        raise ValueError(f"kabsch_filter: at most {KABSCH_MAX_R} raw matches per pair, got {R}")
    dev = valid.device
    inlier = torch.empty((P, R), dtype=torch.bool, device=dev)
    count = torch.empty((P,), dtype=torch.int64, device=dev)
    transform = torch.empty((P, 4, 4), dtype=torch.float32, device=dev)
    valid_pair = torch.empty((P,), dtype=torch.bool, device=dev)
    if P == 0:
        return inlier, count, transform, valid_pair
    lib = load("kabsch_filter")
    _raise_on(lib.bf_kabsch_filter(
        src_pts.data_ptr(), tgt_pts.data_ptr(), pix_src.data_ptr(), pix_tgt.data_ptr(),
        valid.data_ptr(), inlier.data_ptr(), count.data_ptr(), transform.data_ptr(),
        valid_pair.data_ptr(), int(P), int(R), int(max_filtered), int(min_num_matches),
        float(max_res2), _stream(valid)), "kabsch_filter")
    launch_counts["kabsch_filter"] += 1
    return inlier, count, transform, valid_pair


def surface_area_launch(src_pts, tgt_pts, inlier_mask, area_thresh: float):
    """Launch ``surface_area.cu``: the surface-area filter of P image pairs,
    one warp each, on the current stream.

    ``src_pts`` / ``tgt_pts`` [P, R, 3] float32 and ``inlier_mask`` [P, R]
    bool, R at most ``SURFACE_AREA_MAX_R``. Returns ``keep`` [P] bool and
    the two images' areas ``a0`` / ``a1`` [P] float32, on the card. Nothing
    is read back; P = 0 launches nothing."""
    _check_cuda(inlier_mask, torch.bool, "inlier_mask")
    if inlier_mask.dim() != 2:
        raise ValueError(f"inlier_mask: need [P, R], got {tuple(inlier_mask.shape)}")
    P, R = inlier_mask.shape
    for t, what in ((src_pts, "src_pts"), (tgt_pts, "tgt_pts")):
        _check_cuda(t, torch.float32, what, (P, R, 3))
    if R > SURFACE_AREA_MAX_R:
        raise ValueError(f"surface_area: at most {SURFACE_AREA_MAX_R} matches per pair, got {R}")
    dev = inlier_mask.device
    keep = torch.empty((P,), dtype=torch.bool, device=dev)
    a0 = torch.empty((P,), dtype=torch.float32, device=dev)
    a1 = torch.empty((P,), dtype=torch.float32, device=dev)
    if P == 0:
        return keep, a0, a1
    lib = load("surface_area")
    _raise_on(lib.bf_surface_area(
        src_pts.data_ptr(), tgt_pts.data_ptr(), inlier_mask.data_ptr(), keep.data_ptr(),
        a0.data_ptr(), a1.data_ptr(), int(P), int(R), float(area_thresh),
        _stream(inlier_mask)), "surface_area")
    launch_counts["surface_area"] += 1
    return keep, a0, a1


# the culled path's three launchers, at the interfaces of
# ``tsdf.apply_ops.PLAIN_STAGES``
CUDA_STAGES = (tsdf_prepare_launch, tsdf_cull_launch, tsdf_apply_launch)
