"""On the card: each cell runs end to end through the benchmark's command,
correct, with every metric it names. Skips without a card.

    python3 -m pytest -m gpu benchmark/tests/test_portbench_gpu.py -q
"""

import json
import subprocess
import sys

import pytest

from benchmark.tests import tiny


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["forecast_b1", "finetune_b1", "forecast_f32_b1"])
def test_a_cell_runs_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name,
                        "--seed", str(2**31 + 77), "--seconds", "3", "--trace", str(trace)],
                       cwd=tiny.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    c = tiny.cell(name)
    wanted = c.per_layer if trace else c.end_to_end
    assert out["correct"] and set(out["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in wanted}
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
