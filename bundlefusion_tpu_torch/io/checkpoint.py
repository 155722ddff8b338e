"""Engine checkpoint / resume.

Port of ``bundlefusion_tpu/io/checkpoint.py``: the complete engine state
(voxel table and its host-paged blocks, keyframe stores, correspondence
stores, frame archive, trajectories, scheduler records) in one ``.npz`` with
a JSON header, so a half-finished scan resumes where it stopped.

The file has the reference's layout: the arrays of ``local``, ``glob``,
``store`` and ``table`` as ``<tree>.<i>`` in the JAX package's leaf order
(depth first over the fields, which the port's dataclasses share),
bfloat16 leaves as their uint16 bits tagged ``"bf16"``, the scheduler
records as ``tm_*``, the paged blocks as ``hb_*`` and the header as
``meta_json``. So :func:`load_engine` also reads a checkpoint written by the
JAX package; the one field whose shape differs, the table's ``slot_geo``
([N+1, 128] there, [N+1, 4] here), keeps its lanes 0-3, and ``slot_keys``
is checked against ``keys`` / ``slots``. A file the port writes holds the
port's ``slot_geo`` and need not load into the JAX package. A checkpoint
holds no device topology: ``load_engine(path, mesh=)`` restores one onto a
mesh, every rank reading the file.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from bundlefusion_tpu_torch.utils import copy_into

FORMAT_VERSION = 1
_TREES = ("local", "glob", "store", "table")


def _leaves(obj, prefix=""):
    """(field path, tensor) of a state dataclass, depth first over its
    fields: the JAX package's pytree leaf order."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def _pack_leaf(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).cpu().numpy().view(np.uint16), "bf16"
    if x.dtype == torch.uint16:
        return x.view(torch.int16).cpu().numpy().view(np.uint16), "<u2"
    a = x.cpu().numpy()
    return a, a.dtype.str


def _unpack_leaf(a: np.ndarray, tag: str) -> np.ndarray:
    """A stored leaf as numpy; bfloat16 bits widen to float32 (exactly)."""
    if tag == "bf16":
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a


def save_engine(eng, path: str):
    """Serialize a port engine to ``path`` (.npz)."""
    eng._flush_pending()

    arrays = {}
    tags = {}
    for name in _TREES:
        for i, (_, leaf) in enumerate(_leaves(getattr(eng, name))):
            a, tag = _pack_leaf(leaf)
            arrays[f"{name}.{i}"] = a
            tags[f"{name}.{i}"] = tag
    arrays["submap_base"] = eng.submap_base.cpu().numpy()
    arrays["keyframe_valid"] = eng.keyframe_valid
    arrays["sift_world"] = (
        np.stack(eng.sift_world) if eng.sift_world else np.zeros((0, 4, 4), np.float32)
    )
    arrays["complete_traj"] = (
        np.stack(eng.complete_traj) if eng.complete_traj else np.zeros((0, 4, 4), np.float32)
    )
    arrays["frame_valid"] = np.asarray(eng.frame_valid, bool)

    # trajectory-manager records (the re-integration scheduler)
    recs = eng.traj_manager.records
    n = len(recs)
    intT = np.full((n, 4, 4), np.nan, np.float32)
    optT = np.full((n, 4, 4), np.nan, np.float32)
    for i, r in enumerate(recs):
        if r.integrated_transform is not None:
            intT[i] = r.integrated_transform
        if r.optimized_transform is not None:
            optT[i] = r.optimized_transform
    arrays["tm_states"] = np.array([int(r.state) for r in recs], np.int32)
    arrays["tm_int"] = intT
    arrays["tm_opt"] = optT

    # host-paged blocks: the reference saves the whole chunked volume,
    # host-resident chunks included (CUDASceneRepChunkGrid.h:122-141)
    if eng.host_blocks is not None and len(eng.host_blocks):
        hb = eng.host_blocks.blocks
        hkeys = np.fromiter(hb.keys(), np.int64)
        for j, part in enumerate(("hb_sdf", "hb_weight", "hb_color")):
            arrays[part] = np.stack([hb[int(k)][j] for k in hkeys])
        arrays["hb_keys"] = hkeys

    meta = {
        "version": FORMAT_VERSION,
        "tags": tags,
        "app": dataclasses.asdict(eng.app),
        "bundling": dataclasses.asdict(eng.bundling),
        "sift": dataclasses.asdict(eng.sift_cfg),
        "intr": dataclasses.asdict(eng.intr_input),
        "max_keyframes": eng.G,
        "frame_idx": eng.frame_idx,
        "num_keyframes": eng.num_keyframes,
        "recorded_upto": eng._recorded_upto,
        "retry_list": eng.retry_list,
        "retry_attempts": {str(k): v for k, v in eng.retry_attempts.items()},
        "lost_count": eng.lost_count,
        "render_every": eng.render_every,
        "window_base": eng._window_base,
        "anchor_slot": eng._anchor_slot,
    }
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def _nested(obj, flat: dict) -> dict:
    """Field-path keyed arrays -> the nested dicts the ``*_from_numpy``
    builders take, following ``obj``'s dataclass structure."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _nested(v, {k[len(f.name) + 1:]: a for k, a in flat.items()
                                      if k.startswith(f.name + ".")})
        else:
            out[f.name] = flat[f.name]
    return out


def _read_tree(data, tags: dict, name: str, template) -> dict:
    """The stored leaves of tree ``name`` keyed by field path, checked
    against the fresh engine's shapes (``slot_geo`` by its first lanes)."""
    flat = {}
    for i, (path, leaf) in enumerate(_leaves(template)):
        key = f"{name}.{i}"
        a = _unpack_leaf(data[key], tags[key])
        want = tuple(leaf.shape)
        got = a.shape
        if path == "slot_geo" and a.ndim == 2 and a.shape[1] >= want[1]:
            got = (a.shape[0], want[1])
        if got != want:
            raise ValueError(f"checkpoint leaf {key} ({name}.{path}) has shape {a.shape}, "
                             f"the engine's is {want}")
        flat[path] = a
    return flat


def load_engine(path: str, mesh=None, device=None):
    """Reconstruct an engine from a checkpoint written by :func:`save_engine`
    or by the JAX package's ``save_engine``, on ``device`` (the CUDA card
    unless the caller names another, or the mesh's device).

    ``mesh``: optional ``parallel.mesh.Mesh``. Every rank calls this and
    reads the file: each takes the keyframe graph and the host scheduler's
    state, so the replicas start identical; rank 0 also takes the window,
    the frame archive, the voxel table and the paged blocks, which only it
    holds."""
    from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig
    from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
    from bundlefusion_tpu_torch.ops.sift import SiftConfig
    from bundlefusion_tpu_torch.pipeline.online import (
        BundleFusion,
        global_state_from_numpy,
        local_state_from_numpy,
    )
    from bundlefusion_tpu_torch.pipeline.trajectory import FrameRecord, FrameState
    from bundlefusion_tpu_torch.tsdf.table import table_from_numpy

    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta_json"]).decode("utf-8"))
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != {FORMAT_VERSION}")

    eng = BundleFusion(
        CameraIntrinsics(**meta["intr"]), AppConfig(**meta["app"]),
        BundlingConfig(**meta["bundling"]), sift_cfg=SiftConfig(**meta["sift"]),
        max_keyframes=meta["max_keyframes"], mesh=mesh, device=device,
    )
    dev, tags = eng.device, meta["tags"]
    # the trees this rank holds (on a mesh, the keyframe graph alone off rank 0)
    trees = {name: _read_tree(data, tags, name, getattr(eng, name)) for name in _TREES
             if getattr(eng, name) is not None}
    eng.glob = global_state_from_numpy(_nested(eng.glob, trees["glob"]), dev)
    if eng._is_root:
        # the window, the frame archive and the anchor pose are copied into
        # the engine's own storages: its frame graphs read them by address
        copy_into(eng.local, local_state_from_numpy(_nested(eng.local, trees["local"]), dev))
        store = trees["store"]
        eng.store.depth_mm.view(torch.int16).copy_(
            torch.from_numpy(store["depth_mm"].astype(np.uint16).view(np.int16)))
        eng.store.color.copy_(torch.from_numpy(store["color"].astype(np.uint8)))
        eng.table = table_from_numpy(trees["table"], dev)

    eng.submap_base.copy_(torch.as_tensor(data["submap_base"], dtype=torch.float32))
    eng.keyframe_valid = data["keyframe_valid"].copy()
    eng.sift_world = [t.copy() for t in data["sift_world"]]
    eng.complete_traj = [t.copy() for t in data["complete_traj"]]
    eng.frame_valid = [bool(b) for b in data["frame_valid"]]
    eng.frame_idx = meta["frame_idx"]
    eng.num_keyframes = meta["num_keyframes"]
    eng._recorded_upto = meta["recorded_upto"]
    eng.retry_list = list(meta["retry_list"])
    eng.retry_attempts = {int(k): v for k, v in meta["retry_attempts"].items()}
    eng.lost_count = meta["lost_count"]
    eng.render_every = meta["render_every"]
    eng._window_base = meta.get("window_base", 0)
    eng._anchor_slot = meta.get("anchor_slot", 0)
    eng.kf_valid_dev = torch.as_tensor(eng.keyframe_valid, device=dev)

    if "hb_keys" in data and eng._is_root:
        if eng.host_blocks is None:
            raise ValueError("checkpoint holds host-paged blocks but streaming is off")
        eng.host_blocks.insert(data["hb_keys"], data["hb_sdf"], data["hb_weight"],
                               data["hb_color"].reshape(len(data["hb_keys"]), -1))
        eng._refresh_blocked_dev()

    recs = []
    for i in range(len(data["tm_states"])):
        r = FrameRecord()
        r.state = FrameState(int(data["tm_states"][i]))
        iT = data["tm_int"][i]
        oT = data["tm_opt"][i]
        r.integrated_transform = iT.copy() if np.isfinite(iT).all() else None
        r.optimized_transform = oT.copy() if np.isfinite(oT).all() else None
        recs.append(r)
    eng.traj_manager.records = recs
    return eng
