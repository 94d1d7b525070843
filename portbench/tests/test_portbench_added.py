"""A configuration, a traffic mix, a job and a metric added as new files
alone are found by the harness by the names in BENCHMARK.json."""
import json

from conftest import ROOT


def test_new_files_are_found(checkout):
    config = json.loads((ROOT / "portbench/configs/dw1d.json").read_text())
    config.update(name="ou1d", prior_sde="ou", prior_sde_kwargs={"decay": 1.5}, drift_flops=1)
    checkout.write("configs/ou1d.json", config)
    checkout.write("reference/priors/ou.py",
                   "def drift(x, kw, xp):\n    return -kw['decay'] * x\n\n\n"
                   "def jacobian(x, kw):\n    return (-kw['decay'] * x ** 0)[..., None]\n")
    job = (ROOT / "portbench/jobs/cvi_fit.py").read_text()
    checkout.write("jobs/cvi_fit_copy.py", job.replace('"""Job ``cvi_fit``', '"""A copy'))
    checkout.write("metrics/fits_in_window.py",
                   "def read(ctx):\n    return float(len(ctx['fits']))\n")
    checkout.bench["configs"].append({"name": "ou1d", "source": "a test",
                                      "file": "portbench/configs/ou1d.json", "reduced": [],
                                      "why": "a test"})
    checkout.bench["per_layer"].append({"name": "fits_in_window", "unit": "fits",
                                        "better": "higher", "source": "program_counter",
                                        "layer": "trainer", "moves": "fit_s",
                                        "workloads": ["ou1d.tinier"]})
    checkout.add_cell("ou1d.tinier", "dw1d", "tinier",
                      {"job": "cvi_fit_copy", "num_grid": 151, "num_observations": 12,
                       "pool": 1, "pool_seed": 6, "trace_fits": 2, "check_fits": 1})
    checkout.bench["workloads"][-1]["config"] = "ou1d"
    checkout.save()
    result = checkout.run_apart("ou1d.tinier", trace=True)
    assert result["correct"] is True
    assert result["metrics"]["fits_in_window"]["value"] >= 1
    # the metric is the new cell's alone
    assert "fits_in_window" not in checkout.run_apart("dw1d.tiny", trace=True)["metrics"]
