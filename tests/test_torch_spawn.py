"""``--spawn``'s rendezvous (``launch/mesh.py spawn``): three launchers
started at once on the CPU, each spawning a 2 x 2 gloo world
(``launch/train.py`` twice, with and without ``REPRO_OPT_SEQ_PARALLEL``,
and ``launch/serve.py``), all exit 0, and each world met at a file store
of its own in a temporary directory that is gone when it ends: no port is
picked, released and bound again, which another process could take in
between. The sequence-parallel run's records say so, and its first loss
equals the other train run's.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--reduced", "--device", "cpu", "--mesh", "2x2", "--backend", "gloo", "--spawn"]
LAUNCH = {"train": (["train", "--arch", "qwen3-1.7b", "--steps", "2", "--seed", "1"], {}),
          "train_sp": (["train", "--arch", "qwen3-1.7b", "--steps", "2", "--seed", "1"],
                       {"REPRO_OPT_SEQ_PARALLEL": "1"}),
          "serve": (["serve", "--arch", "mixtral-8x7b", "--requests", "2", "--max-new", "2"], {})}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """{name: (stdout, stderr, exit code)} of the three launchers, started
    together, each with a temporary directory of its own (``TMPDIR``),
    and those directories."""
    tmps = {name: tmp_path_factory.mktemp(name) for name in LAUNCH}
    procs = {}
    for name, (args, extra) in LAUNCH.items():
        env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
        env.update(PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmps[name]), **extra)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.launch.{args[0]}"] + args[1:] + BASE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    out = {}
    try:
        for name, p in procs.items():
            o, e = p.communicate(timeout=300)
            out[name] = (o, e, p.returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out, tmps


def _records(stdout: str) -> list:
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("name", list(LAUNCH))
def test_launchers_started_at_once_all_exit_0(launched, name):
    out, tmps = launched
    stdout, stderr, rc = out[name]
    assert rc == 0, stderr[-3000:]
    recs = _records(stdout)
    assert sorted(r["rank"] for r in recs) == [0, 1, 2, 3]
    assert all(r["seq_parallel"] == (name == "train_sp") for r in recs)
    assert not list(tmps[name].glob("rendezvous-*")), "the rendezvous directory is left"


def test_the_sequence_parallel_launcher_changes_no_loss(launched):
    """The same seed and batches with ``REPRO_OPT_SEQ_PARALLEL=1`` in the
    environment the spawned ranks inherit: the same first loss, printed to
    the last digit (the forward's values are the same; the norms'
    gradients are summed in another order, so the second step's params,
    and its loss, may part in the last bits), and reduce-scatters where the
    flag off all-reduces."""
    out, _ = launched
    losses = {name: [float(v) for v in re.findall(r"loss=(\S+)", out[name][0])]
              for name in ("train", "train_sp")}
    assert len(losses["train"]) == 2 and losses["train"][0] == losses["train_sp"][0]
    assert abs(losses["train"][1] - losses["train_sp"][1]) <= 1e-3 * losses["train"][1]
    assert "seq_parallel=True" in out["train_sp"][0]
    rs = {name: [r["collectives"].get("reduce-scatter", {}).get("count", 0)
                 for r in _records(out[name][0])] for name in ("train", "train_sp")}
    assert all(a > b for a, b in zip(rs["train_sp"], rs["train"])), rs


def test_no_spawner_picks_a_port():
    """No launcher, test world or ``chip_smoke.py`` binds port 0 to pick a
    port for its ranks: every spawner goes through ``launch/mesh.py
    spawn``."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
        (ROOT / "tests").glob("torch_*_world.py")) + [ROOT / "chip_smoke.py"]
    found = [str(p) for p in files if "getsockname" in p.read_text()]
    assert not found, found
    spawners = [p for p in files if "start_processes" in p.read_text()]
    assert spawners == [ROOT / "src" / "repro_torch" / "launch" / "mesh.py"], spawners


def test_init_rank_refuses_a_process_started_by_neither(monkeypatch):
    from repro_torch.launch.mesh import INIT_METHOD_ENV, init_rank
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", INIT_METHOD_ENV):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="not started as a rank"):
        init_rank("gloo")
    monkeypatch.setenv(INIT_METHOD_ENV, "file:///nowhere")
    with pytest.raises(RuntimeError, match=r"\['RANK', 'WORLD_SIZE'\]"):
        init_rank("gloo")
