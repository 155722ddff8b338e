"""fusion_dev_ms (ms, program span): the fusion programs (``_tsdf_fast`` or
``_tsdf_rows``, then the render) per frame, from the engine's replay
(``dev_tsdf``, ``dev_tsdf_rows``, ``dev_render``), the two TSDF paths
weighted by the window's share of re-integration frames."""


def read(rec):
    d = (rec["replay"] or {}).get("device_ms", {})
    if "dev_render" not in d or not ("dev_tsdf" in d or "dev_tsdf_rows" in d):
        return None
    s = rec["reint_share"]
    fast = d.get("dev_tsdf", d.get("dev_tsdf_rows"))
    rows = d.get("dev_tsdf_rows", fast)
    return d["dev_render"] + (1.0 - s) * fast + s * rows
