"""The RATS cell (rrtmg.rats_heartbeat_c90) at 64 x 72 on the CPU: a dry
run in a fresh process reads correct, loads no module of jax or the JAX
package and prints the cell's metrics; the control (the reference
rounded through bfloat16) fails rats_relmax where the port passes every
limit."""

from bench_rats_cell import BENCH, CELL, run_cell, small_root


def test_fresh_process_dry_run_is_correct(tmp_path):
    out, modules, stderr = run_cell(small_root(tmp_path), 2**31 + 13)
    assert not set(modules) & {"jax", "jaxlib", "flax",
                               "geosradiation_gridcomp_tpu"}
    assert "geosradiation_gridcomp_tpu_torch" in modules
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"cycle_ms", "peak_mem_gib", "setup_s"}
    assert {"rats_relmax", "forcing_relmax"} <= set(out["checks"])
    assert "rats_warm_up" in stderr


def test_the_control_fails_rats_relmax_the_port_passes(tmp_path,
                                                       monkeypatch):
    import torch
    torch.set_num_threads(1)
    monkeypatch.syspath_prepend(BENCH)
    import control
    import harness
    cell = harness.load_cell(CELL, small_root(tmp_path))
    limits = cell.workload["limits"]
    port, ctrl = control.readings(cell, 2**31 + 23, 0.5, device="cpu")
    assert set(port) == set(limits)
    assert all(port[k] <= limits[k] for k in limits), port
    assert ctrl["rats_relmax"] > limits["rats_relmax"], ctrl
    assert ctrl["forcing_relmax"] > limits["forcing_relmax"], ctrl
