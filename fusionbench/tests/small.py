"""A small size of every cell, for rehearsals on the CPU: 160x120 input,
80x60 integration at 3 cm voxels, submaps of 4 (the port's test
configuration), and limits for that size."""

SMALL = {
    "config": {
        "camera": {"width": 160, "height": 120, "fx": 142.4, "fy": 142.4, "cx": 79.5, "cy": 59.5},
        "app": {"integration_width": 80, "integration_height": 60, "sdf_voxel_size": 0.03,
                "sdf_truncation": 0.09, "hash_num_sdf_blocks": 8192, "hash_key_capacity": 16384,
                "visible_blocks_cap": 8192},
        "bundling": {"width_sift": 160, "height_sift": 120, "submap_size": 4,
                     "downsampled_width": 40, "downsampled_height": 30, "max_local_corr": 2048,
                     "max_global_corr": 8192, "min_num_matches_local": 4,
                     "min_num_matches_global": 4, "max_num_images": 16},
        "sift": {"num_octaves": 3, "target_keys": 96, "max_candidates_per_octave": 256,
                 "min_scale": 1.0, "dog_thresh": 0.004},
    },
    "traffic": {"warm_frames": 3, "rate_hz": 4.0,
                "trace": {"device_stretch": [1, 3], "gap_stretch": [4, 3], "replay_frames": 4}},
    # at this size tracking is coarse (a few cm) and so is the map
    "limits": {"pose_err_rms_cm": 4.0, "map_weight_gap": 0.3, "map_sdf_off_pct": 10.0,
               "render_depth_p50_mm": 25.0, "map_samples": 20000},
}


def small(cell: str, **traffic) -> dict:
    import copy

    out = copy.deepcopy(SMALL)
    if cell.endswith("offline"):
        # a short closed scan: the bench orbit, 40 frames replayed
        out["traffic"]["scan"] = {"trajectory": "orbit", "radius": 0.4,
                                  "step_rad": 0.014544410433286079, "frames": 40}
    out["traffic"].update(traffic)
    return out
