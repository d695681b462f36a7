"""The control (the reference in the precision below the configuration's,
or the program with its own lower-precision path on) comes out not
correct, where the program's answers do."""

import pytest
import torch

from portbench import control, core
from portbench.tests import tiny

BENCH = core.load_benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_a_limit_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    limits = core.cell(BENCH, workload)[2]["limits"]
    line = next(control.readings(BENCH, workload, [2**31 + 3],
                                 torch.device("cuda", 0)))
    assert all(line["sound"][k] <= limits[k] for k in line["sound"]), line
    assert any(line["control"][k] > limits[k] for k in line["control"]), line


def test_the_bfloat16_map_control_fails_on_a_tiny_net(tmp_path):
    bench, base, root = tiny.make(tmp_path)
    limits = core.cell(bench, "tinynet-map", base, root)[2]["limits"]
    line = next(control.readings(bench, "tinynet-map", [5],
                                 torch.device("cpu"), base, root))
    assert all(line["sound"][k] <= limits[k] for k in line["sound"])
    assert line["control"]["score_err"] > 10 * limits["score_err"]


def test_the_tf32_reference_control_fails_on_a_tiny_clique(tmp_path):
    bench, base, root = tiny.make(tmp_path)
    limits = core.cell(bench, "tinyclique-post", base, root)[2]["limits"]
    line = next(control.readings(bench, "tinyclique-post", [6],
                                 torch.device("cpu"), base, root))
    assert all(line["sound"][k] <= limits[k] for k in line["sound"])
    assert any(line["control"][k] > limits[k] for k in line["control"])
