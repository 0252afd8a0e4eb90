"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``), on the CPU.

The two simulator tours, ``fabric_contention.py`` and
``collectives_demo.py``, print the reference's lines exactly with
``--device cpu``; ``fsdp_mcast_train.py`` trains reduced yi-9b in three modes
to the same step-5 loss (its own assert) and prints the reference's
contention report of full yi-9b; ``quickstart.py`` and ``train_100m.py`` run
to exit 0 at a few steps. Every example runs in a subprocess of its own,
all of them at once (one torch thread each), and none imports jax or the
JAX package.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

from test_torch_support import REPO, SRC

PORT = os.path.join(REPO, "examples_torch")
REF = os.path.join(REPO, "examples")

# the port's runs: name -> argv after the script
PORT_RUNS = {
    "fabric_contention": ["--device", "cpu"],
    "collectives_demo": ["--device", "cpu"],
    "fsdp_mcast_train": ["--device", "cpu"],
    "quickstart": ["--device", "cpu", "--steps", "3"],
    "train_100m": ["--device", "cpu", "--steps", "1"],
}
# the reference's runs: name -> python source run with the examples on the path
REF_RUNS = {
    "fabric_contention": "import runpy; runpy.run_path('fabric_contention.py', "
                         "run_name='__main__')",
    "collectives_demo": "import runpy; runpy.run_path('collectives_demo.py', "
                        "run_name='__main__')",
    "fsdp_mcast_train": "from fsdp_mcast_train import contention_report; contention_report()",
}
# a port run's wrapper: the script as __main__, then no jax nor repro module loaded
_WRAP = ("import runpy, sys\n"
         "sys.argv = sys.argv[1:]\n"
         "runpy.run_path(sys.argv[0], run_name='__main__')\n"
         "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
         "assert not bad, bad\n")


def _env() -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=SRC + os.pathsep + env.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run started at once; (returncode, stdout, stderr) by
    ("port" | "ref", name)."""
    ckpt = str(tmp_path_factory.mktemp("ckpt_100m"))
    procs = {}
    for name, argv in PORT_RUNS.items():
        extra = ["--ckpt-dir", ckpt] if name == "train_100m" else []
        procs["port", name] = subprocess.Popen(
            [sys.executable, "-c", _WRAP, os.path.join(PORT, name + ".py"), *argv, *extra],
            cwd=PORT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, code in REF_RUNS.items():
        procs["ref", name] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=REF, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        out[key] = (proc.returncode, stdout, stderr)
    return out


def _ok(runs, key):
    rc, stdout, stderr = runs[key]
    assert rc == 0, (key, stderr[-3000:])
    return stdout


@pytest.mark.parametrize("name", ["fabric_contention", "collectives_demo"])
def test_simulator_tours_print_the_reference_lines(runs, name):
    got, want = _ok(runs, ("port", name)), _ok(runs, ("ref", name))
    assert got.splitlines() == want.splitlines()
    assert len(want.splitlines()) > 10


def test_fsdp_mcast_train_modes_agree_and_report_as_the_reference(runs):
    got = _ok(runs, ("port", "fsdp_mcast_train"))
    losses = re.findall(r"fsdp_mode=(\S+) +step-5 loss = (\S+)", got)
    assert [m for m, _ in losses] == ["xla", "mcast", "mcast_bcast"]
    assert all(abs(float(v) - float(losses[0][1])) < 1e-5 for _, v in losses)
    assert "all FSDP modes numerically identical" in got
    report = got[got.index("\nsimulated FSDP-step"):].strip().splitlines()
    want = _ok(runs, ("ref", "fsdp_mcast_train")).strip().splitlines()
    assert report == want and len(want) == 6


def test_quickstart_trains_and_decodes(runs):
    got = _ok(runs, ("port", "quickstart"))
    assert "model: smollm-135m-smoke (dense)" in got and "trained 3 steps" in got
    toks = re.search(r"greedy continuation token ids: \[(.*)\]", got).group(1).split(", ")
    assert len(toks) == 9 and all(0 <= int(t) < 256 for t in toks)


def test_train_100m_runs_a_step(runs):
    got = _ok(runs, ("port", "train_100m"))
    assert "[100m] smollm-135m: 134.5M params, B=2 S=64, 1 steps" in got
    assert re.search(r"step +0 +loss 1\d\.\d{4}", got)


def test_examples_name_neither_jax_nor_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b")
    names = sorted(f for f in os.listdir(PORT) if f.endswith(".py"))
    assert names == sorted(n + ".py" for n in PORT_RUNS)
    assert names == sorted(f for f in os.listdir(REF) if f.endswith(".py"))
    for f in names:
        with open(os.path.join(PORT, f)) as fh:
            bad = [line for line in fh if pattern.match(line)]
        assert not bad, (f, bad)


@pytest.mark.parametrize("name", list(PORT_RUNS))
def test_examples_default_to_cuda(name):
    """Without ``--device`` an example runs on the card, and without one it
    raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, os.path.join(PORT, name + ".py")], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "device='cpu'" in res.stderr, res.stderr[-2000:]
