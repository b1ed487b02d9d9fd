"""The port's Slurm launcher (ttt_video_dit_torch/train_submitit.py) on the
CPU, with no submitit installed: where submitit is needed, a fabricated
``submitit`` package written to a temporary directory stands in for it on
PYTHONPATH (or in ``sys.modules``), recording what the launcher asks of it.

- Slurm's node list expands, and a task's Slurm variables become torchrun's;
  a missing one is refused by name.
- ``main`` asks the fabricated AutoExecutor for what the JAX launcher
  (train_submitit.py at the root) asks on the same argv, but one task and
  one card per GPU and its own job name; the timeout reaches
  ``--checkpoint.timeout_minutes``. Without submitit it exits 1 and says so.
- A job requeued twice resumes with one ``--checkpoint.resume``.
- Preempted and requeued end to end: one fabricated Slurm task (gloo, world
  1) trains the tiny model (tests/torch_parallel_runs.py) with a checkpoint
  every step and is preempted in step 3; the Trainer ``checkpoint()``
  returns takes step 3 from the step-2 checkpoint. Its step-3 loss, grad
  norm, sampler state, parameters and Adam moments equal an uninterrupted
  Slurm run's bit for bit (float32 on the CPU: no K4, whose dq order varies
  on the card, chip_smoke.py's phase 9).
- Two tasks (SLURM_NTASKS 2 on 127.0.0.1) form a gloo group and take a step
  as one process takes it, held as tests/test_torch_parallel_train.py holds
  torchrun's ranks.

Run as a script, this file is the worker of the preempt-and-requeue test.
"""

import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_parallel_runs as runs  # noqa: E402
from torch_parallel_runs import REPO, held_to_reference  # noqa: E402

from ttt_video_dit_torch import train_submitit  # noqa: E402
from ttt_video_dit_torch.utils import safetensors  # noqa: E402

FAKE_SUBMITIT = '''"""A fabricated submitit: records what the launcher asks of it (FAKE_SUBMITIT_RECORD)."""
import json
import os


class AutoExecutor:
    def __init__(self, folder, **kwargs):
        self.record = {"init": {"folder": folder, **kwargs}}

    def update_parameters(self, **kwargs):
        self.record["parameters"] = kwargs

    def submit(self, fn, *args, **kwargs):
        self.record.update(argv=fn.argv, callable=f"{type(fn).__module__}.{type(fn).__qualname__}")
        with open(os.environ["FAKE_SUBMITIT_RECORD"], "w") as f:
            json.dump(self.record, f)
        return Job()


class Job:
    job_id = "4242"


class helpers:
    class DelayedSubmission:
        def __init__(self, function, *args, **kwargs):
            self.function, self.args, self.kwargs = function, args, kwargs
'''


def _fake_submitit(tmp_path) -> Path:
    pkg = tmp_path / "fake" / "submitit"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text(FAKE_SUBMITIT)
    return pkg.parent


def _free_job_id() -> str:
    """A SLURM_JOB_ID whose MASTER_PORT (PORT_BASE + id mod PORT_SPAN) is free now."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if train_submitit.PORT_BASE <= port < train_submitit.PORT_BASE + train_submitit.PORT_SPAN:
            return str(port - train_submitit.PORT_BASE)


def _slurm(ntasks: int, procid: int, job_id: str) -> dict:
    return {"SLURM_NTASKS": str(ntasks), "SLURM_PROCID": str(procid), "SLURM_LOCALID": str(procid),
            "SLURM_JOB_NODELIST": "127.0.0.1", "SLURM_JOB_ID": job_id}


@pytest.mark.parametrize("nodelist,hosts", [
    ("gpu[01-03,07],login5", ["gpu01", "gpu02", "gpu03", "gpu07", "login5"]),
    ("node7", ["node7"]),
    ("127.0.0.1", ["127.0.0.1"]),
    ("rack[1-2]-n[09-10]", ["rack1-n09", "rack1-n10", "rack2-n09", "rack2-n10"]),
    ("a[8-11],b", ["a8", "a9", "a10", "a11", "b"]),
])
def test_nodelist_expands(nodelist, hosts):
    assert train_submitit.expand_nodelist(nodelist) == hosts


@pytest.mark.parametrize("nodelist", ["gpu[01", "gpu[[1]]", "a,,b", "gpu[3-1]", "gpu[x]", ""])
def test_malformed_nodelist_is_refused(nodelist):
    with pytest.raises(ValueError, match="Slurm node list"):
        train_submitit.expand_nodelist(nodelist)


def test_slurm_variables_become_torchruns():
    env = {"SLURM_NTASKS": "24", "SLURM_PROCID": "13", "SLURM_LOCALID": "5",
           "SLURM_JOB_NODELIST": "gpu[01-03,07],login5", "SLURM_JOB_ID": "123456"}
    assert train_submitit.torchrun_environment(env) == {
        "WORLD_SIZE": "24", "RANK": "13", "LOCAL_RANK": "5", "MASTER_ADDR": "gpu01",
        "MASTER_PORT": str(20000 + 123456 % 40000)}


@pytest.mark.parametrize("missing", train_submitit.SLURM_VARIABLES)
def test_a_missing_slurm_variable_is_refused_by_name(missing, monkeypatch):
    env = {k: v for k, v in _slurm(1, 0, "7").items() if k != missing}
    with pytest.raises(RuntimeError, match=missing):
        train_submitit.torchrun_environment(env)
    for k in train_submitit.SLURM_VARIABLES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=missing):  # before the training entry is touched
        train_submitit.Trainer(["--job.platform", "cpu"])()


def _submit(tmp_path, launcher: list, argv: list) -> dict:
    """What ``launcher argv`` asked of the fabricated submitit (on PYTHONPATH) in a process of its own."""
    fake = tmp_path / "fake"
    if not fake.exists():
        _fake_submitit(tmp_path)
    record = tmp_path / f"record_{len(list(tmp_path.glob('record_*')))}.json"
    env = {**os.environ, "PYTHONPATH": f"{fake}{os.pathsep}{REPO}", "FAKE_SUBMITIT_RECORD": str(record)}
    proc = subprocess.run([sys.executable, *launcher, *argv], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "submitted 4242", proc.stderr
    return json.loads(record.read_text())


TRAIN_ARGV = ["--job.config_file", "configs/train/ttt-mlp/3s.toml", "--model.num_layers", "4"]


@pytest.mark.parametrize("argv,timeout", [
    (TRAIN_ARGV, "720"),
    (["--submitit.partition", "gpu", "--submitit.nodes", "3", "--submitit.timeout-min", "90", "--submitit.folder",
      "logs/%j", "--submitit.max-timeouts", "4", *TRAIN_ARGV], "90"),
    ([*TRAIN_ARGV, "--checkpoint.timeout_minutes", "30", "--submitit.timeout-min", "60"], "30"),
], ids=["defaults", "every_flag", "timeout_given"])
def test_main_asks_what_the_jax_launcher_asks_one_task_per_card(tmp_path, argv, timeout):
    jax_record = _submit(tmp_path, ["train_submitit.py"], argv)
    port = _submit(tmp_path, ["-m", "ttt_video_dit_torch.train_submitit"], argv)
    port8 = _submit(tmp_path, ["-m", "ttt_video_dit_torch.train_submitit"], [*argv, "--submitit.gpus-per-node", "4"])
    assert port["init"] == jax_record["init"]
    assert port["argv"] == jax_record["argv"]
    assert port["argv"][port["argv"].index("--checkpoint.timeout_minutes") + 1] == timeout
    assert port["argv"].count("--checkpoint.timeout_minutes") == 1 and "--checkpoint.resume" not in port["argv"]
    differ = ("tasks_per_node", "gpus_per_node", "name")
    assert {k: v for k, v in port["parameters"].items() if k not in differ} == \
        {k: v for k, v in jax_record["parameters"].items() if k not in differ}
    assert jax_record["parameters"]["tasks_per_node"] == 1 and jax_record["parameters"]["name"] == "ttt-video-tpu"
    assert port["parameters"]["tasks_per_node"] == port["parameters"]["gpus_per_node"] == 8
    assert port8["parameters"]["tasks_per_node"] == port8["parameters"]["gpus_per_node"] == 4
    assert port["parameters"]["name"] == "ttt-video-torch"
    assert port["callable"] == "ttt_video_dit_torch.train_submitit.Trainer"


def test_main_without_submitit_exits_1_and_says_so():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "ttt_video_dit_torch.train_submitit", *TRAIN_ARGV], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and not proc.stdout
    assert "submitit is not installed; install it or launch ttt_video_dit_torch.train" in proc.stderr


def test_a_job_requeued_twice_resumes_once(monkeypatch):
    fake = types.ModuleType("submitit")
    exec(FAKE_SUBMITIT, fake.__dict__)
    monkeypatch.setitem(sys.modules, "submitit", fake)
    first = train_submitit.Trainer(TRAIN_ARGV)
    again = first.checkpoint().function.checkpoint()
    assert type(again.function) is train_submitit.Trainer and again.args == () and again.kwargs == {}
    assert again.function.argv == [*TRAIN_ARGV, "--checkpoint.resume"] and first.argv == TRAIN_ARGV


class Preempted(Exception):
    """Stands in for Slurm's signal: raised in place of step 3."""


def requeue_worker(out: str, fake: str) -> None:
    """An uninterrupted 3-step Slurm run, then one preempted in step 3 and
    its requeued Trainer; writes both summaries' numbers to ``out``."""
    sys.path.insert(0, fake)
    from ttt_video_dit_torch.training import train_step

    dump = Path(out).parent
    flags = runs.train_flags(runs.TTT_MLP, 1, 1, 1, steps=3, global_batch=1) + ["--checkpoint.interval", "1",
                                                                               "--model.video_length", "3sec"]
    ref = train_submitit.Trainer(flags + ["--job.dump_folder", str(dump / "ref")])()
    real, calls = train_step.train_step, []

    def preempted(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise Preempted
        return real(*args, **kwargs)

    train_step.train_step = preempted
    first = train_submitit.Trainer(flags + ["--job.dump_folder", str(dump / "run")])
    try:
        first()
        raise AssertionError("the first run was not preempted")
    except Preempted:
        pass
    finally:
        train_step.train_step = real
    saved = sorted(os.listdir(dump / "run" / "checkpoint"))
    delayed = first.checkpoint()
    resumed = delayed.function(*delayed.args, **delayed.kwargs)
    keys = ("start_step", "losses", "grad_norms")
    with open(out, "w", encoding="utf-8") as f:
        json.dump({"ref": {k: ref[k] for k in keys}, "resumed": {k: resumed[k] for k in keys},
                   "saved_before": saved, "argv": delayed.function.argv,
                   "sampler_equal": ref["sampler_state"] == resumed["sampler_state"],
                   "mesh": [ref["mesh"], resumed["mesh"]]}, f)


def test_preempted_job_resumes_bit_for_bit(tmp_path):
    out = tmp_path / "result.json"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", **_slurm(1, 0, _free_job_id())}
    proc = subprocess.run([sys.executable, __file__, str(out), str(_fake_submitit(tmp_path))], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(out.read_text())
    assert r["saved_before"] == ["1", "2"] and r["argv"].count("--checkpoint.resume") == 1
    assert r["mesh"] == [[1, 1, 1], [1, 1, 1]]  # through torchrun's branch: a gloo group of one
    ref, resumed = r["ref"], r["resumed"]
    assert ref["start_step"] == 0 and len(ref["losses"]) == 3
    assert resumed["start_step"] == 2 and resumed["losses"] == ref["losses"][2:]
    assert resumed["grad_norms"] == ref["grad_norms"][2:] and r["sampler_equal"]
    for name in ("model", "optimizer"):
        want = safetensors.load_file(str(tmp_path / "ref" / "checkpoint" / "3" / f"{name}.safetensors"))
        got = safetensors.load_file(str(tmp_path / "run" / "checkpoint" / "3" / f"{name}.safetensors"))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)


def test_two_slurm_tasks_form_a_group_and_step_as_one_process(tmp_path):
    flags = runs.train_flags(runs.TTT_MLP, 1, 2, 1, steps=1) + ["--job.dump_folder", str(tmp_path)]
    job_id = _free_job_id()
    code = "import sys; from ttt_video_dit_torch.train_submitit import Trainer; Trainer(sys.argv[1:])()"
    procs = [subprocess.Popen([sys.executable, "-c", code, *flags], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
                                   **_slurm(2, rank, job_id)}) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-3000:] for o in outs]
    assert "x 2 ranks, mesh replica x fsdp x tensor = 1 x 2 x 1" in outs[0][0]
    held_to_reference(tmp_path, flags, data_ranks=2, steps=1)


@pytest.mark.parametrize("script,entry,multi_card", [
    ("torch_train_singlehost.sh", "ttt_video_dit_torch.train", True),
    ("torch_train_multihost.sh", "ttt_video_dit_torch.train", True),
    ("torch_sample.sh", "ttt_video_dit_torch.sample", True),
    ("torch_precompute.sh", "ttt_video_dit_torch.data.precompute_video", False),
])
def test_port_launch_scripts_parse_and_call_the_port(script, entry, multi_card):
    path = REPO / "scripts" / script
    assert subprocess.run(["bash", "-n", str(path)], capture_output=True).returncode == 0
    text = path.read_text()
    assert f"-m {entry}" in text and ("torchrun" in text) == multi_card and "ttt_video_dit_tpu" not in text
    assert os.access(path, os.X_OK)


if __name__ == "__main__":
    requeue_worker(sys.argv[1], sys.argv[2])
