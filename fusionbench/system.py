"""The system under test: ``bundlefusion_tpu_torch``'s public engine.

The only module of the benchmark that imports the program. It builds the
engine at a configuration, feeds it frames through ``upload_frame`` and
``process_frame`` (one call each per frame, as the command line feeds a
decoded scan), marks each frame's completion on the device, and, once the
window has closed, reads the outputs that ``check.py`` judges: the
trajectory after ``finish``, a seeded sample of the map's voxels and the
last per-frame render. The spans and counters that the per-layer readers
take (``device_timing``, ``timing``, ``reint_frames``; with ``trace`` on,
the span records and counters of ``program``) are the engine's own.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 8   # voxels per block side, the map's layout
CROSS_GAP = 100   # keyframes apart (1000 frames at submaps of 10): a loop closure


class Done:
    """The completion of work already done (the CPU runs synchronously)."""

    def synchronize(self) -> None:
        pass


class System:
    def __init__(self, config: dict, device: torch.device):
        from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig
        from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
        from bundlefusion_tpu_torch.ops.sift import SiftConfig
        from bundlefusion_tpu_torch.pipeline.online import BundleFusion

        cam = config["camera"]
        intr = CameraIntrinsics(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
                                width=cam["width"], height=cam["height"])
        self.device = device
        # no "sift" group (every cell's configuration): the engine's SIFT
        # settings from the bundling ones; the CPU rehearsal's small size sets one
        sift = SiftConfig(**config["sift"]) if "sift" in config else None
        self.eng = BundleFusion(intr, AppConfig(**config["app"]),
                                BundlingConfig(**config["bundling"]), sift_cfg=sift,
                                device=device)
        self.submap = self.eng.S - 1
        self._last = None

    @staticmethod
    def build_kernels(device: torch.device) -> None:
        """Build the hand kernels (cached in the program's build directory,
        inside the checkout)."""
        if device.type == "cuda":
            from bundlefusion_tpu_torch import kernels

            kernels.build_all()

    def warmup(self) -> None:
        self.eng.warmup()

    def is_boundary(self, f: int) -> bool:
        return f > 0 and f % self.submap == 0

    def upload(self, depth_mm: np.ndarray, color: np.ndarray):
        return self.eng.upload_frame(depth_mm, color)

    def process(self, handle):
        """Run one uploaded frame; returns a handle whose ``synchronize()``
        returns once the frame's pose, fusion and render are done."""
        self._last = self.eng.process_frame(handle)
        if self.device.type != "cuda":
            return Done()
        ev = torch.cuda.Event(blocking=True)
        ev.record()
        return ev

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def reint_frames(self) -> int:
        return self.eng.reint_frames

    @property
    def keyframes(self) -> int:
        """Keyframes in the keyframe graph so far (a host count)."""
        return int(self.eng.num_keyframes)

    def state(self, since: int = 0) -> dict:
        """How far the run filled the engine's state: keyframes and live
        blocks of the map, against their capacities; the global
        correspondence store's rows against its capacity, and the pairs the
        global solves dropped so far; and the loop closures the store holds:
        keyframe pairs more than ``CROSS_GAP`` keyframes apart with a
        correspondence that no pruning invalidated (``cross_pairs``), and of
        them those whose newer keyframe is ``since`` or later
        (``cross_pairs_since``). Reads the device."""
        t, corrs = self.eng.table, self.eng.glob.corrs
        n = int(corrs.count)
        i, j = corrs.img_i[:n].long(), corrs.img_j[:n].long()
        far = (i >= 0) & (j >= 0) & ((i - j).abs() > CROSS_GAP)
        pairs = torch.unique(torch.maximum(i, j)[far] * self.eng.G + torch.minimum(i, j)[far])
        newer = pairs // self.eng.G
        return {"keyframes": int(self.eng.num_keyframes), "keyframe_capacity": int(self.eng.G),
                "live_blocks": int((t.slot_geo[:, 3] > 0.5).sum()),
                "block_capacity": int(t.slot_geo.shape[0] - 1),
                "global_corr_rows": n, "global_corr_capacity": int(corrs.capacity),
                "pairs_dropped": int(self.eng.pairs_dropped_total),
                "cross_pairs": int(newer.numel()), "cross_pairs_since": int((newer >= since).sum())}

    def trace(self, on: bool, profiler_ranges: bool = False) -> None:
        """Start or stop the engine's span records (``eng.trace``; with
        ``profiler_ranges``, each span also a ``bf.<name>`` profiler range).
        Nothing for an engine that keeps no spans."""
        if hasattr(self.eng, "spans"):
            self.eng.trace(on, profiler_ranges)

    def program(self):
        """The engine's span records closed since the last call and its
        counters (``eng.spans()``, ``eng.counters()``: read after ``trace``
        is turned off); None for an engine that keeps no spans."""
        if not hasattr(self.eng, "spans"):
            return None
        return {"spans": self.eng.spans(), "counters": self.eng.counters()}

    def replay(self, on: bool) -> None:
        """Turn the engine's serialized device-time replay on or off."""
        self.eng.profile_every = 1 if on else 0

    def device_ms(self) -> dict:
        """Mean ms of each stage of the replay (``device_timing``)."""
        return {k: 1e3 * v for k, v in self.eng.device_timing.averages().items()}

    def stage_totals(self) -> dict:
        """Total s of each host stage so far (``timing``)."""
        return dict(self.eng.timing.totals())

    def last_pose(self) -> np.ndarray:
        """The pose the last ``process_frame`` returned (the one its render
        was made from), camera to world; read before ``finish``."""
        if self._last is None or self._last["pose"] is None:
            return None
        return self._last["pose"].double().cpu().numpy()

    def finish(self) -> None:
        self.eng.finish(extra_solves=2)
        self.sync()

    def trajectory(self) -> np.ndarray:
        return self.eng.trajectory()

    def last_render(self):
        r = self.eng.last_render
        return None if r is None else r["depth"].float().cpu().numpy()

    def map_sample(self, n: int, seed: int, voxel_size: float) -> dict:
        """A seeded sample of ``n`` observed voxels (weight > 0) of the map:
        centres [n, 3] in metres, sdf and weight, on the host."""
        t = self.eng.table
        live = t.slot_geo[:, 3] > 0.5
        seen = (t.weight > 0) & live[:, None]
        cand = torch.nonzero(seen.reshape(-1)).reshape(-1)
        if cand.numel() == 0:
            return {"points": np.zeros((0, 3)), "sdf": np.zeros(0), "weight": np.zeros(0)}
        g = torch.Generator(device=cand.device)
        g.manual_seed(seed % (2 ** 63))
        pick = cand[torch.randint(cand.numel(), (n,), generator=g, device=cand.device)]
        slot, lin = pick // (BLOCK ** 3), pick % (BLOCK ** 3)
        local = torch.stack([lin % BLOCK, (lin // BLOCK) % BLOCK, lin // (BLOCK * BLOCK)], -1)
        block = t.slot_geo[slot, :3].to(torch.float64)
        pts = (block * BLOCK + local.to(torch.float64) + 0.5) * voxel_size
        return {"points": pts.cpu().numpy(), "sdf": t.sdf.reshape(-1)[pick].double().cpu().numpy(),
                "weight": t.weight.reshape(-1)[pick].double().cpu().numpy()}

    def close(self) -> None:
        """Free the engine's state on the device."""
        self.eng = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
