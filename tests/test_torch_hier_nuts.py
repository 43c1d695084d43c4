"""The ``fith`` CLI with ``-fsa``: ``--move mix`` against the JAX
package, and ``--sampler nuts`` against the port's own stretch run (the
gates and their seed sweep are set out in
``tests/test_torch_hier_cli.py``, whose helpers these tests use).
"""

import pytest
import torch

from test_torch_hier_cli import (
    COMMON, _config, _medians_close, _posterior, _run,
    _same_files_and_columns, jax_main, port_main)

torch.set_num_threads(2)
FSA_RUN = ["-fsa", "--move", "mix", "-ns", "2000", "-nw", "64"]
FSA_BASE = "t_nb50_nw64_ns2000_mcf50"


@pytest.fixture(scope="module")
def port_fsa_run(tmp_path_factory):
    """The port's ``fith -fsa --move mix --use-pallas`` stretch run."""
    tmp = tmp_path_factory.mktemp("fith_fsa")
    return _run(port_main, str(tmp / "port"),
                ["fith"] + COMMON + FSA_RUN + _config(tmp)
                + ["--device", "cpu", "--use-pallas"])


def test_fith_fsa_mix_cli_through_the_kernel_path(tmp_path, port_fsa_run):
    """``-fsa`` (every theta index shifts by one) with ``--move mix``,
    through ``--use-pallas``: on the CPU the kernels' plain versions, the
    code path the card takes up to the kernel launch."""
    jdir, jfiles = _run(jax_main, str(tmp_path / "jax"),
                        ["fith"] + COMMON + FSA_RUN + _config(tmp_path))
    tdir, tfiles = port_fsa_run
    _same_files_and_columns(jdir, jfiles, tdir, tfiles)
    tpost = _posterior(tdir, FSA_BASE)
    assert len(tpost) == 15 and r"$\alpha$" not in tpost
    _medians_close(tpost, _posterior(jdir, FSA_BASE), 0.5)


def test_fith_nuts_cli_matches_the_stretch_run(tmp_path, port_fsa_run):
    """``fith --sampler nuts`` through the plain value+gradient version
    of the hierarchical kernel writes the stretch run's artifact names
    and columns, and its medians lie within 1 posterior sd of it."""
    ndir, nfiles = _run(port_main, str(tmp_path / "nuts"),
                        ["fith", "--sampler", "nuts", "-fsa", "-ns", "150",
                         "--nchains", "4", "--device", "cpu", "--use-pallas"]
                        + COMMON + _config(tmp_path))
    sdir, sfiles = port_fsa_run
    nbase = "t_nb50_nw100_ns150_mcf50"
    assert [f.replace(nbase, "") for f in nfiles] == [
        f.replace(FSA_BASE, "") for f in sfiles]
    npost = _posterior(ndir, nbase)
    assert len(npost["Ln Prob"]) == 150 * 4
    _medians_close(npost, _posterior(sdir, FSA_BASE), 1.0)
