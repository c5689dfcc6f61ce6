"""The result line, the judged checks and the import check."""

import json
import os
import subprocess
import sys

from port_bench.harness import result, spec


def test_judge_holds_every_number_to_its_limit():
    limits = {"a": {"limit": 1.0}, "b": {"limit": 0.0}}
    ok, checks = result.judge({"a": 0.5, "b": 0.0}, limits)
    assert ok and list(checks) == ["a", "b"]
    assert not result.judge({"a": 2.0, "b": 0.0}, limits)[0]
    assert not result.judge({"a": 0.5}, limits)[0]          # missing
    ok, checks = result.judge({"a": float("inf"), "b": 0.0}, limits)
    assert not ok and checks["a"]["value"] is None
    assert not result.judge({"a": float("nan"), "b": 0.0}, limits)[0]


def test_last_line_shape(capsys):
    result.emit(correct=True, attempted=3, failed=0,
                metrics={"setup_s": {"value": 1.5, "unit": "s"}},
                device={"platform": "gpu", "kind": "x", "count": 1,
                        "memory_peak_bytes": 1},
                checks={"a": {"value": 0.1, "limit": 1.0}},
                breakdown={"device_ops": [["k", 0.1]], "idle_gaps": []})
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert err.strip().splitlines()[-1] == "check a: 0.1 (limit 1.0)"


def test_forbidden_modules_by_whole_top_level_name():
    assert result.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert result.forbidden_modules(["music_generation_tpu_torch.serve",
                                     "flaxen"]) == []
    assert result.forbidden_modules(["music_generation_tpu.models"]) == [
        "music_generation_tpu"]


def _python(code, cwd=spec.ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_reference_imports_nothing_of_the_program():
    pkgs = ["port_bench.reference." + p for p in (
        "pipeline", "train_step", "mas", "models.svs", "frontend")]
    code = ("import sys\n" + "".join(f"import {p}\n" for p in pkgs)
            + "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'music_generation_tpu_torch', 'music_generation_tpu', "
            "'jax', 'flax', 'optax', 'orbax', 'jaxlib'})\nprint(bad)")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_harness_imports_no_jax():
    code = ("import sys\nimport port_bench.run, port_bench.control\n"
            "from port_bench.drivers import score_batches, gan_train\n"
            "import music_generation_tpu_torch.pipeline.synthesis\n"
            "import music_generation_tpu_torch.train\n"
            "from port_bench.harness.result import forbidden_modules\n"
            "print(forbidden_modules())")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_device_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "svs_v6.scores_b16", "--seed", "2147483649", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
