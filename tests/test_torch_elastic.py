"""The port's ``distributed.elastic``, ``launch`` and ``spawn`` against
the JAX package's, after ``tests/test_preemption_resume.py``'s elastic
tests: the resume-step threading and stall counting, restart budgets and
backoff, a dead rank of a tiny torch worker restarting and resuming from
the newest verified step to the uninterrupted stream, and a stalled
heartbeat detected. Every rank is a fresh interpreter (``subprocess``)
with a bounded wait."""

import json
import os
import signal
import sys
import time

import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

from paddle_tpu.distributed import elastic as jelastic  # noqa: E402
from paddle_tpu.distributed import launch as jlaunch  # noqa: E402
from paddle_tpu_torch.distributed import elastic as telastic  # noqa: E402
from paddle_tpu_torch.distributed import launch as tlaunch  # noqa: E402
from paddle_tpu_torch.distributed.spawn import spawn as tspawn  # noqa: E402
from paddle_tpu_torch.io.checkpoint import \
    latest_manifest_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_constants_and_env_names_equal_jax():
    for name in ("RESTART_EXIT_CODE", "HB_DIR_ENV", "RESTART_COUNT_ENV",
                 "RESUME_STEP_ENV"):
        assert getattr(telastic, name) == getattr(jelastic, name)
    assert [s.value for s in telastic.ElasticStatus] == \
        [s.value for s in jelastic.ElasticStatus]
    assert tlaunch.trainer_env(1, 4, "127.0.0.1:1234") == \
        jlaunch.trainer_env(1, 4, "127.0.0.1:1234")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_resume_step_threading_and_stall_count(tmp_path, pkg):
    el = jelastic if pkg == "jax" else telastic

    def manifest(step):
        json.dump({"format": 1, "step": step, "digests": {}},
                  open(str(tmp_path / f"manifest-{step}.json"), "w"))

    mgr = el.ElasticManager(nproc=1, training_script="x.py",
                            script_args=[], checkpoint_dir=str(tmp_path))
    assert mgr._latest_verified() is None
    manifest(5)
    assert mgr._latest_verified() == 5
    manifest(9)
    mgr._spawn_resume_step = 9
    assert mgr._note_resume_progress() is True
    assert mgr._note_resume_progress() is True
    assert mgr._resume_stalls == 2
    manifest(12)
    assert mgr._note_resume_progress() is False
    assert mgr._resume_stalls == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_respawn_backoff_curve(pkg):
    el = jelastic if pkg == "jax" else telastic
    mgr = el.ElasticManager(nproc=1, training_script="x.py",
                            script_args=[], restart_backoff=0.01,
                            restart_backoff_cap=0.04)
    mgr._gen_start = time.time()
    delays = [mgr._respawn_backoff(healthy=False) for _ in range(4)]
    assert mgr._respawn_backoff(healthy=True) == 0.0
    assert mgr._backoff_level == 0
    assert delays == [0.01, 0.02, 0.04, 0.04]


_STDLIB_TRAIN = """
import json, os, sys
work = sys.argv[1]
resume = os.environ.get("PADDLE_ELASTIC_RESUME_STEP")
incarnation = int(os.environ.get("PADDLE_ELASTIC_RESTART_COUNT", 0))
with open(os.path.join(work, "log.txt"), "a") as f:
    f.write(json.dumps({"inc": incarnation, "resume": resume,
                        "rank": os.environ["RANK"],
                        "world": os.environ["WORLD_SIZE"]}) + "\\n")
start = 0 if resume is None else int(resume)
for step in range(start + 1, start + 4):
    man = os.path.join(work, "ckpt", f"manifest-{step}.json")
    json.dump({"format": 1, "step": step, "digests": {}},
              open(man + ".tmp", "w"))
    os.replace(man + ".tmp", man)
if incarnation == 0:
    os._exit(17)   # crash after committing 3 steps
"""


def test_restart_is_pinned_to_newest_verified_step(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(_STDLIB_TRAIN)
    (tmp_path / "ckpt").mkdir()
    mgr = telastic.ElasticManager(
        nproc=1, training_script=str(script),
        script_args=[str(tmp_path)], max_restarts=2,
        poll_interval=0.05, restart_backoff=0.05,
        checkpoint_dir=str(tmp_path / "ckpt"))
    assert mgr.run() == 0
    log = [json.loads(line)
           for line in (tmp_path / "log.txt").read_text().splitlines()]
    assert [(r["inc"], r["resume"]) for r in log] == [(0, None), (1, "3")]
    assert latest_manifest_step(str(tmp_path / "ckpt")) == 6
    assert mgr._resume_stalls == 0 and mgr.restarts == 1


def test_stalled_exit_67_loop_is_damped(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(
        "import os, sys\n"
        "path = os.path.join(sys.argv[1], 'runs.txt')\n"
        "n = os.path.getsize(path) if os.path.exists(path) else 0\n"
        "open(path, 'a').write('x')\n"
        f"os._exit(0 if n >= 3 else {telastic.RESTART_EXIT_CODE})\n")
    (tmp_path / "ckpt").mkdir()
    json.dump({"format": 1, "step": 4, "digests": {}},
              open(str(tmp_path / "ckpt" / "manifest-4.json"), "w"))
    mgr = telastic.ElasticManager(
        nproc=1, training_script=str(script),
        script_args=[str(tmp_path)], max_restarts=0, poll_interval=0.02,
        restart_backoff=0.2, restart_backoff_cap=0.4,
        checkpoint_dir=str(tmp_path / "ckpt"))
    t0 = time.perf_counter()
    assert mgr.run() == 0
    assert mgr._resume_stalls == 3
    assert time.perf_counter() - t0 >= 0.4


def test_stalled_heartbeat_is_detected(tmp_path):
    """A rank that beats progress, then wedges with its process alive:
    the manager reads the stale progress file as a stall (status
    RESTART, exit code None) and tears the generation down."""
    script = tmp_path / "wedge.py"
    script.write_text(
        "import sys, time\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from paddle_tpu_torch.distributed.elastic import Heartbeat\n"
        "hb = Heartbeat(mode='manual')\n"
        "hb.beat()\n"
        "time.sleep(120)\n")
    mgr = telastic.ElasticManager(
        nproc=1, training_script=str(script), script_args=[],
        max_restarts=0, heartbeat_timeout=1.0, poll_interval=0.05,
        log_dir=str(tmp_path / "logs"))
    t0 = time.perf_counter()
    mgr._spawn()
    status, code = mgr._watch_generation()
    assert status is telastic.ElasticStatus.RESTART and code is None
    assert time.perf_counter() - t0 < 60
    assert all(p.poll() is not None for p in mgr._procs)


_TORCH_WORKER = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as tpt
from paddle_tpu_torch.distributed import restart_count

work = sys.argv[1]
out = open(os.path.join(work, "losses.jsonl"), "a")


class Net(tpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tpt.nn.Linear(8, 16)
        self.fc2 = tpt.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


class Tap(tpt.callbacks.Callback):
    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        g = self.epoch * 8 + step
        out.write(json.dumps([restart_count(), g,
                              float(logs["loss"]).hex()]) + "\n")
        out.flush()
        if restart_count() == 0 and g == 6 and sys.argv[2] == "crash":
            os._exit(17)   # the rank dies mid-run


tpt.seed(0)
torch.manual_seed(0)
net = Net()
m = tpt.Model(net)
m.prepare(tpt.optimizer.AdamW(learning_rate=1e-2, parameters=net),
          lambda lo, la: -torch.log_softmax(lo, -1).gather(-1, la).mean())
rs = np.random.RandomState(3)
x, y = rs.randn(32, 8).astype(np.float32), rs.randint(0, 4, (32, 1))
loader = tpt.io.DataLoader(tpt.io.TensorDataset([x, y]), batch_size=4,
                           shuffle=True, device="cpu")
m.fit(loader, epochs=2, verbose=0, callbacks=[Tap()],
      checkpoint_dir=os.path.join(work, "ck"), checkpoint_freq=2,
      async_checkpoint=False, resume="auto")
'''


def _torch_job(work, mode):
    os.makedirs(work, exist_ok=True)
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(_TORCH_WORKER)
    mgr = telastic.ElasticManager(
        nproc=1, training_script=script, script_args=[work, mode],
        max_restarts=1, poll_interval=0.05, restart_backoff=0.05,
        env_extra={"PYTHONPATH": ROOT},
        checkpoint_dir=os.path.join(work, "ck"))
    rc = mgr.run()
    rows = [json.loads(line) for line in
            open(os.path.join(work, "losses.jsonl"))]
    return rc, mgr, rows


def test_dead_rank_restarts_and_resumes_to_the_same_stream(tmp_path):
    """A torch worker's rank dies after step 6 (checkpoints at 2, 4, 6):
    the manager respawns it pinned to step 6, and the losses of both
    generations together equal the uninterrupted job's."""
    rc, _, base = _torch_job(str(tmp_path / "base"), "plain")
    assert rc == 0 and [g for _, g, _ in base] == list(range(16))
    rc, mgr, rows = _torch_job(str(tmp_path / "crash"), "crash")
    assert rc == 0 and mgr.restarts == 1 and mgr.generation == 1
    gen1 = [g for inc, g, _ in rows if inc == 1]
    assert gen1[0] == 6 and gen1[-1] == 15
    got = {g: h for _, g, h in rows}
    assert got == {g: h for _, g, h in base}


def test_launch_sets_the_trainer_env(tmp_path):
    script = tmp_path / "env.py"
    script.write_text(
        "import json, os, sys\n"
        "keys = ('PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM', 'RANK',\n"
        "        'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')\n"
        "json.dump({k: os.environ[k] for k in keys},\n"
        "          open(os.path.join(sys.argv[1],\n"
        "               os.environ['RANK'] + '.json'), 'w'))\n")
    assert tlaunch.main(["--nproc_per_node", "2", str(script),
                         str(tmp_path)]) == 0
    envs = [json.load(open(tmp_path / f"{r}.json")) for r in (0, 1)]
    assert [e["RANK"] for e in envs] == ["0", "1"]
    assert {e["WORLD_SIZE"] for e in envs} == {"2"}
    assert envs[0]["MASTER_PORT"] == envs[1]["MASTER_PORT"]
    # --nnodes 2 is the multi-node agent's route: without a rendezvous
    # directory or endpoint the parser refuses it, as the JAX launcher's
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--nnodes", "2", str(script)])
    assert e.value.code == 2


def test_spawn_joins_and_surfaces_a_rank_failure():
    ctx = tspawn(print, args=("rank up",), nprocs=2, join=False)
    assert ctx.join(timeout=60) is True
    assert all(p.exitcode == 0 for p in ctx.processes)
    with pytest.raises(RuntimeError, match="spawned rank 0 failed"):
        tspawn(int, args=("not a number",), nprocs=1, join=False
                     ).join(timeout=60)


def test_launcher_forwards_sigterm_and_exits_67(tmp_path):
    """``install_signal_forwarding``: a SIGTERM to the launcher reaches
    every rank, and the launcher exits RESTART_EXIT_CODE."""
    launcher = tmp_path / "launcher.py"
    launcher.write_text(
        "import sys, time\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from paddle_tpu_torch.distributed.elastic import ElasticManager\n"
        f"m = ElasticManager(1, {str(tmp_path / 'sleep.py')!r}, [])\n"
        "m.install_signal_forwarding()\n"
        "m._spawn()\n"
        f"open({str(tmp_path / 'up')!r}, 'w').close()\n"
        "m._watch_generation()\n")
    (tmp_path / "sleep.py").write_text("import time\ntime.sleep(120)\n")
    import subprocess
    p = subprocess.Popen([sys.executable, str(launcher)])
    try:
        t0 = time.time()
        while not (tmp_path / "up").exists():
            assert p.poll() is None and time.time() - t0 < 60
            time.sleep(0.05)
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == telastic.RESTART_EXIT_CODE
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)
