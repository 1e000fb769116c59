"""`gnnbench/run.py` exits non-zero and prints no result without a card, and
in a directory that holds only BENCHMARK.json and the benchmark's files."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "routenet_train", "--seed", str(2 ** 35), "--seconds", "1", "--trace", "0"]


def run(cwd, entry, env_extra=None):
    import os

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, *entry, *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("entry", [["gnnbench/run.py"], ["-m", "gnnbench.run"]])
def test_no_card_no_result(entry):
    out = run(ROOT, entry)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gnnbench", tmp_path / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_out"))
    out = run(tmp_path, ["gnnbench/run.py"])
    assert out.returncode != 0 and out.stdout.strip() == ""
    # past the look for a card, the run stops where it needs the program
    drive = ("import sys, time, torch; sys.path.insert(0, '.'); from gnnbench import harness; "
             "harness.execute(harness.load_cell('routenet_train'), 1, 0.1, False, "
             "torch.device('cpu'), time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", drive], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "No module named 'ignnition_tpu_torch'" in out.stderr
