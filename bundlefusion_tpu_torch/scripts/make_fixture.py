"""Write the tiny ``.sens`` fixture: 12 synthetic 160x120 RGB-D frames with
their true poses, JPEG colour and zlib depth.

Counterpart of ``scripts/make_fixture.py`` (which wrote the committed
``tests/fixtures/tiny.sens``). Writes ``<out>/tiny.sens``. JPEG encoding
needs ``cv2``, imported where it is used: the CUDA machine this repo is
measured on has none, so run it with ``--device cpu`` there.

Usage:
  python -m bundlefusion_tpu_torch.scripts.make_fixture [--device cpu] [--out DIR]
"""

from __future__ import annotations

import json
import os

from bundlefusion_tpu_torch.scripts import common

N_FRAMES = 12


def main(argv=None) -> dict:
    a = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.resolve_device(a.device)
    from bundlefusion_tpu_torch.io.sens import encode_frames, save_sens
    from bundlefusion_tpu_torch.io.synthetic import default_intrinsics, make_sequence

    intr = default_intrinsics(160, 120)
    seq = make_sequence(N_FRAMES, intr=intr, device=dev)
    data = encode_frames(seq["depth"], seq["color"], seq["poses"], intr)
    os.makedirs(a.out, exist_ok=True)
    path = os.path.join(a.out, "tiny.sens")
    save_sens(path, data)
    out = {"path": path, "frames": N_FRAMES, "bytes": os.path.getsize(path),
           "platform": common.platform(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
