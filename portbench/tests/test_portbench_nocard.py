"""A run on a machine without a card, or in a folder without the program,
exits non-zero and prints no result: it never falls back to the CPU."""
import json
import os
import shutil
import subprocess
import sys

from portbench import spec


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dense_knn_readme.train_b8",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            assert "correct" not in json.loads(line)
        except json.JSONDecodeError:
            pass


def test_no_card_fails_without_a_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run(spec.ROOT, env)
    assert out.returncode != 0
    _no_result(out)


def test_a_folder_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
