"""Hand-held motion: ``scene.synthetic.handheld_trajectory``.

``poses(n, seed, **params)`` -> (n, 4, 4) camera-to-world poses; the
traffic file's ``motion`` gives ``t_step``, ``r_step`` and the two spans
(``rpy_span``, ``fast_span``: null leaves one out, absent keeps the
default).
"""

from __future__ import annotations

import numpy as np

from portbench.scene.synthetic import handheld_trajectory


def poses(n: int, seed: int, **params) -> np.ndarray:
    kw = dict(params)
    for span in ("rpy_span", "fast_span"):
        if span in kw and kw[span] is not None:
            kw[span] = tuple(kw[span])
    return handheld_trajectory(n, seed=seed, **kw)
