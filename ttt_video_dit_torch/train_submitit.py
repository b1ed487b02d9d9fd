"""Slurm launcher of the port's training entry, requeued after preemption or
timeout (port of train_submitit.py at the repository's root).

    python -m ttt_video_dit_torch.train_submitit --job.config_file configs/train/ttt-mlp/3s.toml \\
        --submitit.partition gpu --submitit.nodes 8 --submitit.gpus-per-node 8 --submitit.timeout-min 720

The flags, their defaults and the argv handling are the JAX launcher's:
``--submitit.partition`` (default ``tpu``, that launcher's: name the
cluster's GPU partition), ``--submitit.nodes``, ``--submitit.timeout-min``,
``--submitit.folder``, ``--submitit.max-timeouts``; every other flag goes to
the training entry, with ``--checkpoint.timeout_minutes`` appended from the
timeout unless given (the loop saves before the wall clock,
training/iterator.py), and ``--checkpoint.resume`` appended once when a job
is requeued (``Trainer.checkpoint``), so it resumes from its latest
checkpoint.

One difference: one task per card, not one process per host.
``--submitit.gpus-per-node`` (default 8) sets both the tasks and the cards a
node. Each task is one rank, as torchrun would start it.

Only submission (``main``: submitit's AutoExecutor) and requeue
(``Trainer.checkpoint``: its DelayedSubmission, which only submitit itself
calls) import submitit. The half that runs inside the job does not:
``Trainer.__call__`` reads the task's Slurm variables and exports what
torchrun would (:func:`torchrun_environment`), then runs
``train.main(train.parse_args(argv))``, whose ``parallel/mesh.py:
init_distributed`` joins the process group on ``cuda:LOCAL_RANK``.
Without submitit, ``main`` prints why and exits 1.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

# Slurm variables a task needs, and what each becomes.
SLURM_VARIABLES = ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID", "SLURM_JOB_NODELIST", "SLURM_JOB_ID")
# MASTER_PORT = PORT_BASE + SLURM_JOB_ID mod PORT_SPAN: the same for every task of a job and after a requeue
# (Slurm keeps the job's id), different for jobs that share a first node.
PORT_BASE, PORT_SPAN = 20000, 40000


def expand_nodelist(nodelist: str) -> list[str]:
    """Slurm's compressed host list, expanded: ``gpu[01-03,07],login5`` ->
    gpu01, gpu02, gpu03, gpu07, login5 (zero padding kept; several bracket
    groups in one name expand in order)."""
    hosts, part, depth = [], "", 0
    for ch in nodelist + ",":
        depth += (ch == "[") - (ch == "]")
        if depth not in (0, 1):
            raise ValueError(f"malformed Slurm node list {nodelist!r}")
        if ch == "," and depth == 0:
            if not part:
                raise ValueError(f"malformed Slurm node list {nodelist!r}")
            hosts += _expand_host(part, nodelist)
            part = ""
        else:
            part += ch
    if depth or part:
        raise ValueError(f"malformed Slurm node list {nodelist!r}")
    return hosts


def _expand_host(name: str, nodelist: str) -> list[str]:
    m = re.search(r"\[([^\[\]]*)\]", name)
    if m is None:
        return [name]
    head, rest = name[: m.start()], _expand_host(name[m.end() :], nodelist)
    out = []
    for span in m.group(1).split(","):
        lo, _, hi = span.partition("-")
        if not lo.isdigit() or not (hi or lo).isdigit() or int(hi or lo) < int(lo):
            raise ValueError(f"malformed range {span!r} in Slurm node list {nodelist!r}")
        out += [f"{head}{n:0{len(lo)}d}{tail}" for n in range(int(lo), int(hi or lo) + 1) for tail in rest]
    return out


def torchrun_environment(environ) -> dict[str, str]:
    """The variables torchrun would give this task, from its Slurm ones:
    WORLD_SIZE = SLURM_NTASKS, RANK = SLURM_PROCID, LOCAL_RANK =
    SLURM_LOCALID, MASTER_ADDR = the first host of SLURM_JOB_NODELIST,
    MASTER_PORT = PORT_BASE + SLURM_JOB_ID mod PORT_SPAN. A missing variable
    raises, naming it."""
    missing = [name for name in SLURM_VARIABLES if not environ.get(name)]
    if missing:
        raise RuntimeError(f"not in a Slurm task: {', '.join(missing)} not set (srun or submitit sets them)")
    return {"WORLD_SIZE": environ["SLURM_NTASKS"], "RANK": environ["SLURM_PROCID"],
            "LOCAL_RANK": environ["SLURM_LOCALID"], "MASTER_ADDR": expand_nodelist(environ["SLURM_JOB_NODELIST"])[0],
            "MASTER_PORT": str(PORT_BASE + int(environ["SLURM_JOB_ID"]) % PORT_SPAN)}


def requeue_argv(argv) -> list[str]:
    """``argv`` with ``--checkpoint.resume``, once."""
    argv = list(argv)
    if "--checkpoint.resume" not in argv:
        argv.append("--checkpoint.resume")
    return argv


class Trainer:
    """Checkpointable callable: submitit pickles it into the job and again
    at each requeue."""

    def __init__(self, argv):
        self.argv = list(argv)

    def __call__(self) -> dict:
        """Train in this Slurm task. Returns the training entry's summary
        without the model and optimizer (submitit pickles what a job returns)."""
        os.environ.update(torchrun_environment(os.environ))
        from ttt_video_dit_torch import train

        summary = train.main(train.parse_args(self.argv))
        return {k: v for k, v in summary.items() if k not in ("model", "optimizer")}

    def checkpoint(self):
        """Requeue on preemption or timeout, resuming from the latest checkpoint."""
        import submitit

        return submitit.helpers.DelayedSubmission(Trainer(requeue_argv(self.argv)))


def main(argv=None) -> None:
    try:
        import submitit
    except ImportError:
        print("submitit is not installed; install it or launch ttt_video_dit_torch.train per node manually "
              "(torchrun --nproc_per_node <cards> -m ttt_video_dit_torch.train ...)", file=sys.stderr)
        sys.exit(1)

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--submitit.partition", dest="partition", default="tpu")
    parser.add_argument("--submitit.nodes", dest="nodes", type=int, default=1)
    parser.add_argument("--submitit.gpus-per-node", dest="gpus_per_node", type=int, default=8)
    parser.add_argument("--submitit.timeout-min", dest="timeout_min", type=int, default=720)
    parser.add_argument("--submitit.folder", dest="folder", default="slurm_logs/%j")
    parser.add_argument("--submitit.max-timeouts", dest="max_timeouts", type=int, default=15)
    args, train_argv = parser.parse_known_args(argv)

    executor = submitit.AutoExecutor(folder=args.folder, slurm_max_num_timeout=args.max_timeouts)
    executor.update_parameters(
        nodes=args.nodes,
        tasks_per_node=args.gpus_per_node,  # one rank per card
        gpus_per_node=args.gpus_per_node,
        slurm_partition=args.partition,
        timeout_min=args.timeout_min,
        name="ttt-video-torch",
    )
    if "--checkpoint.timeout_minutes" not in train_argv:
        train_argv += ["--checkpoint.timeout_minutes", str(args.timeout_min)]

    job = executor.submit(Trainer(train_argv))
    print(f"submitted {job.job_id}")


if __name__ == "__main__":
    # Submit the importable Trainer, which submitit pickles by reference, not this script's __main__ copy.
    from ttt_video_dit_torch.train_submitit import main as submit

    submit()
