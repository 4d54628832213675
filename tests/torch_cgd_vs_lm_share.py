"""css-cgd against css-lm on ``chip_smoke.py``'s ARIMA(2,1,2) panel, in
the JAX package and in the port, both in float64 on the CPU: the share
of lanes whose css-cgd negative CSS log likelihood is within ``rtol``
(relative) of the css-lm fit's, and the shares where css-cgd ends worse
or better.  ``css_cgd_path`` in ``chip_smoke.py`` holds the card's share
to a 0.90 floor; this script says what the reference itself reaches on
the same panel, with jax's own line search and with the port's
(``torch_jax_line_search``).  From the root of the repository::

    JAX_PLATFORMS=cpu python tests/torch_cgd_vs_lm_share.py --lanes 512

Add ``--float32`` to fit the panel in float32, as the card does.  Prints
one JSON line per package and a last line with the share of lanes on
which the port and jax with the port's line search agree whether
css-cgd is within ``rtol``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

RTOL = 1e-4


def shares(nll_cgd: np.ndarray, nll_lm: np.ndarray, rtol: float = RTOL):
    """``(within, worse, better, sane)``: the shares over the lanes where
    both are finite, and that mask."""
    sane = np.isfinite(nll_cgd) & np.isfinite(nll_lm)
    rel = np.abs(nll_cgd - nll_lm) / np.abs(nll_lm)
    within = rel <= rtol
    worse = nll_cgd > nll_lm * (1 + rtol)
    better = nll_cgd < nll_lm * (1 - rtol)
    return (float(within[sane].mean()), float(worse[sane].mean()),
            float(better[sane].mean()), sane, within)


def port_nll(values: np.ndarray):
    """The port's css-cgd and css-lm negative CSS log likelihoods."""
    import torch

    from spark_timeseries_tpu_torch.models import arima

    v = torch.from_numpy(values)
    cgd = arima.fit(2, 1, 2, v, method="css-cgd", warn=False, device="cpu")
    lm = arima.fit(2, 1, 2, v, warn=False, device="cpu")
    return ((-cgd.log_likelihood_css(v)).double().numpy(),
            (-lm.log_likelihood_css(v)).double().numpy())


def jax_nll(values: np.ndarray):
    """The JAX package's css-cgd and css-lm negative CSS log
    likelihoods."""
    import jax
    jax.config.update("jax_enable_x64", values.dtype == np.float64)
    import jax.numpy as jnp

    from spark_timeseries_tpu.models import arima

    v = jnp.asarray(values)
    cgd = arima.fit(2, 1, 2, v, method="css-cgd", warn=False)
    lm = arima.fit(2, 1, 2, v, warn=False)
    return (-np.asarray(cgd.log_likelihood_css(v)).astype(np.float64),
            -np.asarray(lm.log_likelihood_css(v)).astype(np.float64))


def jax_fixed_nll(values: np.ndarray):
    """:func:`jax_nll` with the port's line search."""
    from torch_jax_line_search import without_line_search_faults
    with without_line_search_faults():
        return jax_nll(values)


def panel(lanes: int, seed: int = 0) -> np.ndarray:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke.synthetic_arima_panel(lanes, 128, seed) \
        .astype(np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--float32", action="store_true")
    args = ap.parse_args(argv)
    values = panel(args.lanes, args.seed)
    if args.float32:
        values = values.astype(np.float32)
    masks = {}
    for name, fn in (("jax", jax_nll), ("jax_port_line_search",
                                        jax_fixed_nll), ("port", port_nll)):
        within, worse, better, sane, mask = shares(*fn(values))
        masks[name] = (sane, mask)
        print(json.dumps({"package": name, "lanes": int(sane.sum()),
                          "within_1e-4": within, "worse": worse,
                          "better": better}), flush=True)
    ref = masks["jax_port_line_search"]
    both = ref[0] & masks["port"][0]
    agree = float((ref[1] == masks["port"][1])[both].mean())
    print(json.dumps({"lanes_sane_in_both": int(both.sum()),
                      "within_mask_agreement": agree}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
