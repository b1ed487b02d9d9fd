"""Logging: a text log, the stats history, optional wandb (port of
ttt_video_dit_tpu/utils/logging.py). Under torchrun only rank 0 writes
(files, stdout, wandb); the other ranks' loggers do nothing.

The text log goes to stdout and to ``log_<exp_name>_<time>.txt``; every
step's stats are appended to ``all_stats.jsonl`` (one JSON record a line), a
copy of the history is written into each checkpoint directory and read back
on resume, and the wandb run id rides in the checkpoint's metadata. wandb is
used only when enabled and importable; a failed import or init is logged and
training goes on without it.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict, Optional

from ttt_video_dit_torch.parallel.mesh import is_main_process

STATS_NAME = "all_stats.jsonl"


class MultiLogger:
    def __init__(self, dump_folder: str, exp_name: str = "job", enable_wandb: bool = False,
                 wandb_project: str = "ttt-video", wandb_entity: Optional[str] = None,
                 wandb_run_id: Optional[str] = None):
        self.is_main = is_main_process()
        self.dump_folder = dump_folder
        self.stats: list[Dict[str, Any]] = []
        self._wandb = None
        self.wandb_run_id = wandb_run_id
        if not self.is_main:
            return
        os.makedirs(dump_folder, exist_ok=True)
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in exp_name)
        self.log_path = os.path.join(dump_folder, f"log_{safe}_{stamp}.txt")
        # Append-only: one record a step; the full history is rewritten only at checkpoints and resume.
        self.stats_path = os.path.join(dump_folder, STATS_NAME)
        self._fh = open(self.log_path, "a", encoding="utf-8")
        if enable_wandb:
            try:
                import wandb

                run = wandb.init(project=wandb_project, entity=wandb_entity, id=wandb_run_id,
                                 resume="must" if wandb_run_id else None)
                self._wandb = wandb
                self.wandb_run_id = run.id
            except Exception as e:  # noqa: BLE001 -- wandb is optional; never fail training over it
                self.write(f"wandb disabled ({e})")

    def write(self, msg: str) -> None:
        if not self.is_main:
            return
        line = f"[{datetime.datetime.now().strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        self._fh.write(line + "\n")
        self._fh.flush()

    def log_stats(self, step: int, stats: Dict[str, Any]) -> None:
        if not self.is_main:
            return
        record = {"global_step": step, **stats}
        self.stats.append(record)
        if self._wandb is not None:
            self._wandb.log(stats, step=step)
        with open(self.stats_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")

    def alert(self, title: str, text: str) -> None:
        """A wandb alert when wandb is on; always logged here, never fails the run."""
        if not self.is_main:
            return
        self.write(f"ALERT [{title}] {text}")
        if self._wandb is not None:
            try:
                self._wandb.alert(title=title, text=text)
            except Exception as e:  # noqa: BLE001
                self.write(f"wandb alert failed ({e})")

    def _write_history(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for record in self.stats:
                f.write(json.dumps(record) + "\n")

    def load_stats(self, src_dir: str) -> None:
        """Restore the history snapshotted into a checkpoint directory (a
        pre-JSONL ``all_stats.json`` too) and rewrite the live file to it, so
        later appends continue from the checkpoint's step; without one, warn."""
        if not self.is_main:
            return
        path, legacy = os.path.join(src_dir, STATS_NAME), os.path.join(src_dir, "all_stats.json")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                self.stats = [json.loads(line) for line in f if line.strip()]
        elif os.path.exists(legacy):
            with open(legacy, encoding="utf-8") as f:
                self.stats = json.load(f)
        else:
            self.write("WARNING: resuming without a stats-history snapshot")
            return
        self._write_history(self.stats_path)

    def snapshot_stats(self, dst_dir: str) -> None:
        """Write the stats history into a checkpoint directory."""
        if not self.is_main:
            return
        os.makedirs(dst_dir, exist_ok=True)
        self._write_history(os.path.join(dst_dir, STATS_NAME))

    def init_log(self, job_config, model_config, num_params: int, device) -> None:
        import torch

        if not self.is_main:
            return
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        self.write(f"experiment: {getattr(job_config.job, 'exp_name', '?')}")
        self.write(f"device: {device} ({name})")
        self.write(f"parameters: {num_params:,}")
        self.write(f"model config: {model_config}")

    def close(self) -> None:
        if self.is_main:
            self._fh.close()
