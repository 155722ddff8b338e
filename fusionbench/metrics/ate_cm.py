"""ate_cm (cm, host clock): the ATE RMSE of ``trajectory()`` after
``finish``, Kabsch-aligned to the generator's poses over the valid frames
fed, as BundleFusion's ``evaluateAteRmse``. Only an open loop, which feeds
a fixed count of frames, reads the same work in every run."""

import math


def read(rec):
    return rec["ate_cm"] if math.isfinite(rec["ate_cm"]) else None
