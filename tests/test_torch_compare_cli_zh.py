"""The model-comparison CLI of both packages for ``fitz`` and ``fith``
(``fit``'s in ``tests/test_torch_compare_cli.py``): ``--ic --ppc
--evidence 4``, on ``fith`` with ``--evidence-swap 2 --evidence-tune 1``,
write the same artifact file names and table columns through both
CLIs, and the port's IC reconstruction check holds at float64
roundoff."""

import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.utils.io import read_fixed_width_two_line
from tests.test_torch_compare_cli import ARGS, run_both

torch.set_num_threads(2)


@pytest.mark.parametrize("command,outdir,extra", [
    ("fitz", "LFMCMCzOut", []),
    ("fith", "LFMCMCHOut", ["--evidence-swap", "2", "--evidence-tune", "1"]),
])
def test_z_and_hier_analyses_match_jax_artifacts(tmp_path, command, outdir,
                                                 extra):
    argv = [command] + ARGS + ["-o", "a.dat", "--ic", "--ppc",
                               "--evidence", "4"] + extra
    jdir, tdir = run_both(tmp_path, argv, outdir)
    base = "a_nb50_nw16_ns60_mcf50"
    for kind in ("ic", "ppc", "evidence"):
        got = read_fixed_width_two_line(str(tdir / f"{kind}_{base}.dat"))
        want = read_fixed_width_two_line(str(jdir / f"{kind}_{base}.dat"))
        assert list(got) == list(want)
    ic = read_fixed_width_two_line(str(tdir / f"ic_{base}.dat"))
    assert int(ic["n_sources"][0]) > 100
    pw = np.load(tdir / f"ic_pointwise_{base}.npz")
    assert pw["elpd_loo_i"].shape == (int(ic["n_sources"][0]),)
    ev = read_fixed_width_two_line(str(tdir / f"evidence_{base}.dat"))
    assert ev["Beta"][0] == 0.0 and ev["Beta"][-1] == 1.0
    assert np.isfinite(ev["LnZ_SS"]).all()
