"""What the benchmark loads and how it finds its cells: no module of JAX or
of the JAX package in a run, none of the program in the reference, every
cell's files and readers present, and a cell added as data found without
editing any file."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import cells, cli

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"


def _python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout


def test_forbidden_names_compare_whole_top_level_names():
    assert cli.forbidden_modules(["headpose_tpu_torch", "jaxtyping",
                                  "headpose_tpu_torch.runtime", "numpy"]) == []
    assert cli.forbidden_modules(["jax.numpy", "headpose_tpu.ops", "flax",
                                  "jaxlib"]) == ["flax", "headpose_tpu.ops",
                                                 "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax():
    """The harness, every metric reader and a whole (tiny, CPU) run of the
    program and the reference leave no module of JAX or the JAX package
    loaded."""
    out = _python(
        "import json, time\n"
        "from perfbench.harness import cells, cli, metrics\n"
        "from perfbench.runners import stream, mesh\n"
        "import perfbench.readings\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "[metrics.reader(m['name']) for m in bench['per_layer']]\n"
        "cell = cells.load('flagship.fast-b256-128px')\n"
        "cell.traffic.update(batch=2, ring=1, warmup_batches=1,"
        " check_batches=1)\n"
        "stream.run(cell, 2**31 + 5, 0.3, False, time.perf_counter(),"
        " device='cpu')\n"
        "print(json.dumps(cli.forbidden_modules()))\n")
    assert json.loads(out.splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    out = _python(
        "import json, sys, numpy as np\n"
        "from perfbench.reference.detector import Reference\n"
        "cfg = json.load(open('perfbench/configs/flagship.fast.json'))\n"
        "Reference(cfg, cfg['weights']).detect("
        "np.load('tests/golden/parity_corpus.npz')['imgs'][:2])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = set(json.loads(out.splitlines()[-1]))
    assert not top & {"headpose_tpu_torch", "headpose_tpu", "jax", "flax"}


def test_benchmark_names_its_files():
    """Every cell's configuration, traffic and limits file, and every
    per-layer metric's reader, is where the harness looks for it; every
    cell reports setup_s, another end-to-end metric and a per-layer one."""
    import re

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert re.match(NAME, w["name"]) and len(w["why"]) <= 200
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


def test_a_cell_added_as_data_is_found(tmp_path):
    """A configuration, a traffic mix and a limits file dropped into a copy
    of the benchmark, with the cell's entry in its BENCHMARK.json, make a
    cell the harness loads, with no other file edited."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "flagship.fast.json").read_text())
    cfg["score_threshold"] = 0.5
    (pb / "configs" / "flagship.strict.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "b256-128px.json").read_text())
    traffic["batch"] = 32
    (pb / "traffic" / "b32-128px.json").write_text(json.dumps(traffic))
    shutil.copy(pb / "limits" / "flagship.fast-b256-128px.json",
                pb / "limits" / "flagship.strict-b32-128px.json")
    bench["configs"].append({"name": "flagship.strict", "source": "x",
                             "file": "perfbench/configs/flagship.strict.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "flagship.strict-b32-128px",
                               "config": "flagship.strict",
                               "traffic": "b32-128px", "chips": 1,
                               "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load("flagship.strict-b32-128px", root=str(tmp_path))
    assert cell.traffic["batch"] == 32
    assert cell.config["score_threshold"] == 0.5
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"} | {
        m["name"] for m in bench["end_to_end"] if "workloads" not in m}
    assert all(p.read_bytes() == data for p, data in before.items())
    with pytest.raises(KeyError):
        cells.load("no-such-cell", root=str(tmp_path))
