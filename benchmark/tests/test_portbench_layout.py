"""The benchmark as data: ``BENCHMARK.json`` within its contract, each
configuration, architecture, traffic, limits, metric and kernel found by
name, and a new cell with a new metric and kernel, and a second
architecture, run by adding files alone."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import arch, harness, kernels
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_its_contract():
    spec = tiny.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        if m["name"] != "setup_s":  # 5x the widest spread measured, and at least 1%
            assert m["bound"] == 0.01, m
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in spec["workloads"]:
        c = harness.load_cell(spec, w["name"], tiny.ROOT)
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert c.traffic["loop"] in ("rollout", "train")
        assert any(m["name"] != "setup_s" for m in c.end_to_end) and c.per_layer
        for m in c.end_to_end + c.per_layer:
            harness.metric_reader(m["name"])
    for c in spec["configs"]:
        with open(os.path.join(tiny.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"] == []


def test_kernel_files_name_the_programs_counters():
    """K1-K7 are there, and every kernel file, these and any added later,
    names its patterns, a launch counter of the program and its work."""
    import importlib

    mods = kernels.load_all()
    assert {f"K{i}" for i in range(1, 8)} <= set(mods)
    for name, mod in mods.items():
        assert mod.PATTERNS and all(isinstance(p, str) for p in mod.PATTERNS), name
        assert callable(mod.work), name
        module, attr = mod.COUNTER
        assert isinstance(getattr(importlib.import_module(module), attr), int), name


def test_every_configuration_names_an_architecture_that_keeps_the_contract():
    spec = tiny.spec()
    loops = {}
    for w in spec["workloads"]:
        c = harness.load_cell(spec, w["name"], tiny.ROOT)
        loops.setdefault(w["config"], set()).add(c.traffic["loop"])
    for c in spec["configs"]:
        with open(os.path.join(tiny.ROOT, c["file"])) as f:
            config = json.load(f)
        parts = arch.TRAINING if "train" in loops[c["name"]] else ()
        mod = harness.architecture(config, parts)
        assert isinstance(mod.TINY, dict)
        assert all(callable(getattr(mod, f)) for f in arch.FORECAST + parts if f != "TINY")
    with pytest.raises(FileNotFoundError, match="no_such_model"):
        harness.architecture({"architecture": "no_such_model"})


NEW_TRAFFIC = {"loop": "rollout", "batch": 2, "lead_steps": 2, "pool": 2, "warmup_steps": 1,
               "checked_steps": 2, "check_forecasts": 1, "profiled_steps": 1,
               "dispatch_steps": 2}
NEW_METRIC = '''
def read(rec):
    return float(rec.window.steps + rec.profile.launches["K99"] * 0)
'''
NEW_KERNEL = '''
PATTERNS = ("no_such_kernel",)
COUNTER = ("pangu_tpu_torch.ops.fused_mlp", "BLOCK_LAUNCHES")


def work(st, c, heads, shifted, batch):
    return 0, 0, 1
'''
SCRIPT = '''
import json, sys, time, torch
from types import SimpleNamespace
from benchmark import harness, run
from benchmark.loops import rollout
spec = json.loads(sys.argv[1])
cell = harness.load_cell(spec, "tiny_pair_b2", sys.argv[2])
cell.config["model"].update(harness.architecture(cell.config).TINY)
ctx = SimpleNamespace(cell=cell, seed=3, seconds=0.2, trace=True, device=torch.device("cpu"),
                      peaks=None, t0=time.perf_counter(), counters=run.counters())
rec = rollout.run(ctx)
print(json.dumps({"metrics": harness.read_metrics(rec, cell.per_layer, required=False),
                  "kernels": sorted(ctx.counters), "correct": rec.correct}))
'''


def test_a_new_cell_metric_and_kernel_by_adding_files(tmp_path):
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    (bench / "traffic" / "tiny_pair.json").write_text(json.dumps(NEW_TRAFFIC))
    (bench / "limits" / "tiny_pair_b2.json").write_text(
        (bench / "limits" / "forecast_b1.json").read_text())
    (bench / "metrics" / "steps_seen.py").write_text(NEW_METRIC)
    (bench / "kernels" / "K99.py").write_text(NEW_KERNEL)
    spec = tiny.spec()
    spec["configs"][0]["file"] = "benchmark/configs/pangu_weather_24h_bf16.json"
    spec["workloads"].append({"name": "tiny_pair_b2", "config": spec["configs"][0]["name"],
                              "traffic": "tiny_pair", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "steps_seen.tiny", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "rollout",
                              "moves": "forecast_rate", "workloads": ["tiny_pair_b2"]})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), tiny.ROOT]))
    p = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(spec), str(tmp_path)],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["metrics"]["steps_seen.tiny"]["value"] >= 1 and "K99" in out["kernels"]
    assert out["correct"]


TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy3")
TOY_CONFIG = {"architecture": "toy3", "allow_tf32": False, "reduced": [],
              "model": {"n": 96, "split": [4, 2, 3], "hidden": 16, "compute_dtype": "float32"}}
TOY_TRAFFIC = {"loop": "rollout", "batch": 2, "lead_steps": 3, "pool": 2, "warmup_steps": 1,
               "checked_steps": 3, "check_forecasts": 2, "profiled_steps": 1,
               "dispatch_steps": 2}
TOY_SCRIPT = '''
import json, sys, time, torch
from types import SimpleNamespace
from benchmark import harness, run
from benchmark.loops import rollout, train
spec, root = json.loads(sys.argv[1]), sys.argv[2]


def go(name, loop):
    cell = harness.load_cell(spec, name, root)
    ctx = SimpleNamespace(cell=cell, seed=2**31 + 9, seconds=0.2, trace=True,
                          device=torch.device("cpu"), peaks=None, t0=time.perf_counter(),
                          counters=run.counters())
    rec = loop.run(ctx)
    return {"correct": rec.correct, "compared": rec.compared, "checks": rec.checks,
            "metrics": harness.read_metrics(rec, cell.per_layer, required=False)
            | harness.read_metrics(rec, cell.end_to_end, required=True)}


out = {"sound": go("toy3_rollout", rollout)}
toy = harness.architecture(json.load(open(root + "/benchmark/configs/toy3.json")))
real = toy.forecast_step


def altered(model, aux):
    step = real(model, aux)

    def wrong(*state):
        a, b, c = step(*state)
        return a, b, c + 0.01

    return wrong


toy.forecast_step = altered
out["altered"] = go("toy3_rollout", rollout)
try:
    go("toy3_train", train)
except AttributeError as e:
    out["train"] = str(e)
print(json.dumps(out))
'''


def test_a_second_architecture_by_adding_files(tmp_path):
    """A toy architecture whose state holds three fields, with its own
    model and plain reference, runs the rollout loop correct; its program
    with the third field altered reads not correct; and a train cell on it,
    which lacks the training part, is refused by name."""
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    shutil.copy(os.path.join(TOY, "arch.py"), bench / "arch" / "toy3.py")
    shutil.copy(os.path.join(TOY, "reference.py"), bench / "reference" / "toy3.py")
    (bench / "configs" / "toy3.json").write_text(json.dumps(TOY_CONFIG))
    (bench / "traffic" / "toy3_rollout.json").write_text(json.dumps(TOY_TRAFFIC))
    (bench / "limits" / "toy3_rollout.json").write_text(
        json.dumps({"rel_rms": 1e-5, "max_abs": 1e-4}))
    (bench / "limits" / "toy3_train.json").write_text(
        (bench / "limits" / "finetune_b1.json").read_text())
    spec = tiny.spec()
    spec["configs"].append({"name": "toy3", "source": "a test", "reduced": [], "why": "a test",
                            "file": "benchmark/configs/toy3.json"})
    spec["workloads"] += [{"name": "toy3_rollout", "config": "toy3", "traffic": "toy3_rollout",
                           "chips": 1, "why": "a test"},
                          {"name": "toy3_train", "config": "toy3", "traffic": "finetune_b1",
                           "chips": 1, "why": "a test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("forecast_rate", "dispatch_ms.forecast"):
            m["workloads"].append("toy3_rollout")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), tiny.ROOT]))
    p = subprocess.run([sys.executable, "-c", TOY_SCRIPT, json.dumps(spec), str(tmp_path)],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    sound, altered = out["sound"], out["altered"]
    assert sound["compared"] == 3 and sound["correct"], sound["checks"]
    assert sound["metrics"]["forecast_rate"]["value"] > 0
    assert sound["metrics"]["dispatch_ms.forecast"]["value"] >= 0
    assert altered["compared"] == 3 and not altered["correct"], altered["checks"]
    assert altered["checks"]["max_abs"][0] >= 0.009
    assert "'toy3'" in out["train"] and "train_step" in out["train"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    from benchmark.run import BANNED

    for dirpath, _, files in os.walk(os.path.join(tiny.ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                tops = {m.split(".")[0] for m in _imports(path)}
                assert not tops & set(BANNED), path
                if os.sep + "reference" + os.sep in path:
                    assert tops <= {"__future__", "math", "dataclasses", "typing", "torch"}, path


def test_banned_names_are_compared_whole():
    from benchmark.run import banned_modules

    assert banned_modules(["jax.numpy", "pangu_tpu.aux", "pangu_tpu_torch.model", "jaxtyping",
                           "flax"]) == ["flax", "jax", "pangu_tpu"]
    assert banned_modules(["pangu_tpu_torch", "pangu_tpu_torch.ops", "jaxlibx"]) == []


def _modules_after(code):
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    tops = _modules_after("import benchmark.reference.pangu")
    assert not tops & {"pangu_tpu_torch", "pangu_tpu", "jax", "jaxlib", "flax"}


def test_a_whole_run_loads_no_jax():
    tops = _modules_after(textwrap.dedent("""
        from benchmark.tests import tiny
        tiny.run(tiny.cell("finetune_b1"), seconds=0.1, trace=True)
        tiny.run(tiny.cell("forecast_b1"), seconds=0.1)"""))
    assert "pangu_tpu_torch" in tops and not tops & {"pangu_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("alone", [False, True])
def test_without_a_card_a_run_fails_and_prints_no_result(tmp_path, alone):
    cwd = tiny.ROOT
    if alone:  # a directory holding only BENCHMARK.json and the benchmark's files
        shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), tmp_path / "benchmark")
        shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
        cwd = str(tmp_path)
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "forecast_b1",
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=cwd, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""
