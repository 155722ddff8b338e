"""The serialized device-time replay (``profile_every`` / ``device_timing``)
of the port's engine against the JAX engine's, on the CPU.

Both engines run the configuration of ``tests/test_torch_engine.py`` over
nine frames with ``profile_every=2``: frames 2, 4, 6 and 8 are replayed with
a device synchronisation around each stage (a no-op on the CPU). The port's
``device_timing`` must hold the JAX engine's stage names with the same
number of samples (the boundaries 4 and 8 under ``dev_submap``, the TSDF
split by path), every sample a non-negative time, and the frames that are
not replayed must leave it alone.
"""

import numpy as np
import pytest

from bundlefusion_tpu.config import AppConfig, BundlingConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.ops.sift import SiftConfig
from bundlefusion_tpu.pipeline.online import BundleFusion as JaxEngine
from tests.test_torch_engine import BUND, N_FRAMES, _port_engine
from tests.torch_parity import APP, SIFT

PROFILE_EVERY = 2


@pytest.fixture(scope="module")
def both():
    intr = default_intrinsics(160, 120)
    seq = make_sequence(N_FRAMES, intr=intr)
    jeng = JaxEngine(intr, AppConfig(**APP), BundlingConfig(**BUND),
                     sift_cfg=SiftConfig(**SIFT), max_keyframes=8)
    teng = _port_engine()
    jeng.profile_every = teng.profile_every = PROFILE_EVERY
    samples_after = []
    for i in range(N_FRAMES):
        jeng.process_frame(seq["depth"][i], seq["color"][i])
        teng.process_frame(seq["depth"][i], seq["color"][i])
        samples_after.append(sum(len(v) for v in teng.device_timing._samples.values()))
    return jeng, teng, samples_after


def test_same_stage_names_and_samples_as_jax(both):
    jeng, teng, _ = both
    jcounts = dict(jeng.device_timing._counts)
    tcounts = {k: len(v) for k, v in teng.device_timing._samples.items()}
    assert tcounts == jcounts
    assert {"dev_frame_step", "dev_render", "dev_submap"} <= set(tcounts)
    assert tcounts["dev_submap"] == 2
    n_prof = len(range(PROFILE_EVERY, N_FRAMES, PROFILE_EVERY))
    assert tcounts["dev_frame_step"] == n_prof
    assert tcounts.get("dev_tsdf", 0) + tcounts.get("dev_tsdf_rows", 0) == n_prof


def test_only_replayed_frames_record(both):
    _, teng, samples_after = both
    grew = [f for f in range(N_FRAMES)
            if samples_after[f] > (samples_after[f - 1] if f else 0)]
    assert grew == list(range(PROFILE_EVERY, N_FRAMES, PROFILE_EVERY))
    assert all(np.isfinite(v).all() and min(v) >= 0
               for v in teng.device_timing._samples.values())
