"""On the card: the control of each cell (the plain reference in TF32 in
the program's place; for the training cell also half of each batch left
out) fails one of the cell's numbers, on three seeds, while the program
passes them all. At the program's tiny sizes, so that a test run holds
it; ``python -m port_bench.control`` reads the same at the cells' own
sizes."""

import time

import pytest

from port_bench.harness import result, spec

CELLS = {"svs_v6.scores_b16": dict(pool=32, warmup_batches=1, batch=4,
                                   check_pool=1, check_batches=1),
         "visinger_train.b32": dict(batch=2)}


@pytest.mark.chip
@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_control_fails_and_program_passes(cuda, cell_name):
    cell = spec.load_cell(cell_name)
    cell.traffic.update(CELLS[cell_name])
    driver = spec.driver(cell.traffic["driver"])
    limits = result.load_limits(cell_name)
    for seed in (2147483700, 2147483701, 2147483702):
        out = driver.run(cell, seed=seed, seconds=3.0, trace=False,
                         t_start=time.time(), device="cuda", tiny=True,
                         control=True)
        assert result.judge(out["values"], limits)[0], out["values"]
        controls = out["controls"]
        if "tf32" in controls:
            for name, values in controls.items():
                assert not result.judge(values, limits)[0], (name, values)
        else:
            assert not result.judge(controls, limits)[0], controls
