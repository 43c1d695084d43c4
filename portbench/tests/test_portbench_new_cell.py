"""The harness takes a new cell as data: a configuration file, a traffic
mix of a new kind with the driver it names, a limits file, a per-layer
metric's reader, an end-to-end metric and the entries of
``BENCHMARK.json``, added beside the existing files of a copy, run on the
CPU's plain path without editing any file that was there."""

import hashlib
import json
import os

from portbench.tests.tiny import REPO, run_tiny, tiny_root

# a driver of a new kind: one whole fit, whatever the window, rated in
# fits a second
DRIVER = '''"""Traffic of the kind ``one_fit``: one whole stretch fit."""

from portbench.drivers import stretch_fits as base

LOOP = base.LOOP
warm_up = base.warm_up
check = base.check


def window(cell, model, seed, seconds, tracer, lnprob=None):
    return base.window(cell, model, seed, 0.0, tracer, lnprob=lnprob)


def end_to_end(win):
    return {"fits_per_s": win["attempted"] / (win["t1"] - win["t0"])}
'''


def _digest(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_as_data(tmp_path):
    root = tiny_root(str(tmp_path))
    before = _digest(root)
    repo_before = _digest(os.path.join(REPO, "portbench", "configs"))
    bench = os.path.join(root, "portbench")
    with open(os.path.join(bench, "configs", "flagship.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "flagship_gauss"
    cfg["lfconfig"].update({"quadrature": "gauss", "size_ln": 12})
    with open(os.path.join(bench, "configs", "flagship_gauss.json"),
              "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench, "traffic", "stretch.json")) as fh:
        mix = json.load(fh)
    mix.update({"driver": "one_fit", "nsteps": 24, "why": "one short fit"})
    with open(os.path.join(bench, "traffic", "stretch_short.json"),
              "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(bench, "drivers", "one_fit.py"), "w") as fh:
        fh.write(DRIVER)
    with open(os.path.join(bench, "limits",
                           "flagship_gauss.stretch_short.json"), "w") as fh:
        json.dump({"nonfinite_rows": {"limit": 0}, "dlnp_gap": {"limit": 0.5},
                   "bad_moves": {"limit": 0}, "bad_takes": {"limit": 0}},
                  fh)
    with open(os.path.join(bench, "metrics", "fits_in_window.py"),
              "w") as fh:
        fh.write('"""Whole fits the window ran."""\n\n\n'
                 'def read(run):\n    return run.window.get("attempted")\n')
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "flagship_gauss", "source": "x",
                            "file": "portbench/configs/flagship_gauss.json",
                            "reduced": [], "why": "gauss grid"})
    spec["workloads"].append({"name": "flagship_gauss.stretch_short",
                              "config": "flagship_gauss",
                              "traffic": "stretch_short", "chips": 1,
                              "why": "short fits on a gauss grid"})
    spec["end_to_end"].append({"name": "fits_per_s", "unit": "fits/s",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["flagship_gauss.stretch_short"]})
    spec["per_layer"].append({"name": "fits_in_window", "unit": "fits",
                              "better": "higher", "source": "host_clock",
                              "layer": "ensemble loop",
                              "moves": "fits_per_s",
                              "workloads": ["flagship_gauss.stretch_short"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)

    plain = run_tiny(root, "flagship_gauss.stretch_short", seconds=1.0)
    assert plain["correct"], plain["checks"]
    assert plain["attempted"] == 1
    assert set(plain["metrics"]) == {"fits_per_s", "setup_s"}
    traced = run_tiny(root, "flagship_gauss.stretch_short", seconds=1.0,
                      trace=1)
    assert traced["metrics"]["fits_in_window"]["value"] >= 1
    # BENCHMARK.json gains entries; every other file that was there is
    # byte for byte as it was
    after = _digest(root)
    before.pop("BENCHMARK.json")
    assert {k: after[k] for k in before} == before
    assert _digest(os.path.join(REPO, "portbench", "configs")) == repo_before
