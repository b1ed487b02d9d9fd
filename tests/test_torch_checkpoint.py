"""The port's training infrastructure against the JAX package's on the CPU:
the TrainingIterator (ttt_video_dit_torch/training/iterator.py) under a
patched clock, the EMA (utils/ema.py), the stats history (utils/logging.py),
the grouped AdamW's state dict and the Checkpointer
(training/checkpoint.py): model and optimizer round trip bit for bit, the
latest complete step, a chosen step, an unfinished save ignored, a step
saved again replaced whole; and the per-step generator of the train step.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.models.dit.dit import init_params_  # noqa: E402
from ttt_video_dit_torch.training import iterator as t_iterator  # noqa: E402
from ttt_video_dit_torch.training import optimizer as t_opt  # noqa: E402
from ttt_video_dit_torch.training.checkpoint import Checkpointer  # noqa: E402
from ttt_video_dit_torch.training.train_step import step_generator  # noqa: E402
from ttt_video_dit_torch.utils import ema as t_ema  # noqa: E402
from ttt_video_dit_torch.utils.logging import MultiLogger  # noqa: E402
from ttt_video_dit_tpu.training import iterator as j_iterator  # noqa: E402
from ttt_video_dit_tpu.utils import ema as j_ema  # noqa: E402
from ttt_video_dit_tpu.utils.logging import MultiLogger as JMultiLogger  # noqa: E402

torch.set_num_threads(1)
OPT = dict(lr=1e-3, lr_ssm=1e-2, lr_end=1e-4, lr_schedule="linear", lr_ssm_schedule="cosine", warmup_steps=2,
           total_steps=10)


def _run_iterator(cls, monkeypatch, start, steps, interval, timeout_minutes, step_s):
    """(steps yielded, (step, timeout) checkpoint calls) with each step taking
    ``step_s(step)`` seconds of a fake monotonic clock."""
    clock = {"t": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    calls = []
    it = cls(start, steps, checkpoint_interval=interval, timeout_minutes=timeout_minutes,
             on_checkpoint=lambda s, timeout: calls.append((s, timeout)))
    seen = []
    for step in it:
        seen.append(step)
        clock["t"] += step_s(step)
    return seen, calls, it.ema_step_seconds


@pytest.mark.parametrize("start,steps,interval,timeout,step_s", [
    (0, 7, 2, 0, 1.0),  # interval saves and a final one (7 is not a multiple of 2)
    (0, 6, 3, 0, 1.0),  # the interval divides the last step: no extra final save
    (4, 9, 2, 0, 1.0),  # resumed at step 4
    (0, 10, 0, 10, 100.0),  # no interval; the timeout save once 600 s minus a 100 s step remain
    (0, 12, 5, 12, 60.0),  # both, the timeout save between interval saves
    (0, 5, 0, 1, 0.5),  # a job shorter than the 6-minute margin: the first step with an EMA saves
    (0, 8, 4, 30, 1.0),  # a long wall clock: no timeout save
], ids=["interval", "divides", "resumed", "timeout", "both", "short_job", "no_timeout"])
def test_iterator_matches_jax(monkeypatch, start, steps, interval, timeout, step_s):
    fn = (lambda s: step_s) if step_s != 60.0 else (lambda s: 60.0 + 10.0 * s)  # "both": slowing steps
    got = _run_iterator(t_iterator.TrainingIterator, monkeypatch, start, steps, interval, timeout, fn)
    want = _run_iterator(j_iterator.TrainingIterator, monkeypatch, start, steps, interval, timeout, fn)
    assert got == want
    assert got[0] == list(range(start + 1, steps + 1))
    if timeout and step_s > 1.0:
        assert any(t for _, t in got[1])


@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_matches_jax(use_num_updates):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal((5,)).astype(np.float32)}
    got = t_ema.init({k: torch.from_numpy(v) for k, v in params.items()}, use_num_updates)
    want = j_ema.init({k: jnp.asarray(v) for k, v in params.items()}, use_num_updates)
    for _ in range(5):
        new = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        got = t_ema.update(got, {k: torch.from_numpy(v) for k, v in new.items()}, decay=0.9)
        want = j_ema.update(want, {k: jnp.asarray(v) for k, v in new.items()}, decay=0.9)
        for k in params:
            np.testing.assert_allclose(got.ema_params[k].numpy(), np.asarray(want.ema_params[k]), rtol=1e-6, atol=1e-7)
        assert got.num_updates == int(want.num_updates)
    ema_params, live = t_ema.swap(got, params)
    assert ema_params is got.ema_params and live is params


def test_stats_snapshot_roundtrip_with_jax(tmp_path):
    """The counterpart of tests/test_training.py::test_stats_snapshot_roundtrip:
    a snapshot restores the history and the live file, and the JAX logger
    reads the port's snapshot (the same all_stats.jsonl layout) and back."""
    logger = MultiLogger(dump_folder=str(tmp_path / "logs"))
    logger.log_stats(1, {"train/loss": 0.5, "mfu": None})
    logger.log_stats(2, {"train/loss": 0.25, "mfu": 0.3})
    ckpt = tmp_path / "checkpoint" / "2"
    logger.snapshot_stats(str(ckpt))
    resumed = MultiLogger(dump_folder=str(tmp_path / "logs2"))
    resumed.load_stats(str(ckpt))
    assert resumed.stats == logger.stats
    resumed.load_stats(str(tmp_path / "missing"))  # warns, keeps the history
    assert resumed.stats == logger.stats
    with open(resumed.stats_path) as f:
        assert [json.loads(line) for line in f if line.strip()] == logger.stats
    jax_logger = JMultiLogger(dump_folder=str(tmp_path / "logs3"))
    jax_logger.load_stats(str(ckpt))
    assert jax_logger.stats == logger.stats
    jax_logger.log_stats(3, {"train/loss": 0.125})
    jax_logger.snapshot_stats(str(tmp_path / "checkpoint" / "3"))
    back = MultiLogger(dump_folder=str(tmp_path / "logs4"))
    back.load_stats(str(tmp_path / "checkpoint" / "3"))
    assert back.stats == jax_logger.stats
    for lg in (logger, resumed, back):
        lg.close()


def _model_and_optimizer(seed):
    cfg = __graft_entry__._flagship_config(tiny=True)
    model = init_params_(TorchCogVideoX(cfg), torch.Generator().manual_seed(seed))
    opt = t_opt.build_optimizer(model, **OPT)
    g = torch.Generator().manual_seed(seed + 100)
    for m, v in zip(opt.mu, opt.nu):
        m.copy_(torch.randn(m.shape, generator=g))
        v.copy_(torch.rand(v.shape, generator=g))
    opt.count = 3 + seed
    return model, opt


def _assert_same(model, opt, ref_model, ref_opt):
    got, want = model.state_dict(), ref_model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    assert opt.count == ref_opt.count
    for a, b in zip(opt.mu + opt.nu, ref_opt.mu + ref_opt.nu):
        assert torch.equal(a, b)


def test_checkpoint_roundtrip_latest_and_chosen_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "checkpoint"))
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "checkpoint")):
        ckpt.restore(-1, *_model_and_optimizer(0))
    saved = {}
    for step, seed in ((2, 1), (4, 2)):
        model, opt = _model_and_optimizer(seed)
        info = ckpt.save(step, model, opt, {"epoch_seed": 0, "counter": step}, {"wandb_id": f"run{step}"},
                         extra=lambda path: open(os.path.join(path, "extra.txt"), "w").close())
        assert info["bytes"] == sum(os.path.getsize(os.path.join(ckpt.step_dir(step), f))
                                    for f in os.listdir(ckpt.step_dir(step)))
        saved[step] = (model, opt)
    assert os.path.exists(os.path.join(ckpt.step_dir(4), "extra.txt"))
    # An unfinished save (its temporary directory, or a step directory without its metadata) is ignored.
    os.makedirs(os.path.join(ckpt.directory, ".tmp-9-123"))
    os.makedirs(os.path.join(ckpt.directory, "7"))
    assert ckpt.latest_step() == 4
    for step in (-1, 2):
        model, opt = _model_and_optimizer(9)
        got_step, sampler, metadata = ckpt.restore(step, model, opt)
        want_step = 4 if step == -1 else step
        assert got_step == want_step and sampler == {"epoch_seed": 0, "counter": want_step}
        assert metadata == {"step": want_step, "optimizer_count": saved[want_step][1].count,
                            "wandb_id": f"run{want_step}"}
        _assert_same(model, opt, *saved[want_step])
    with pytest.raises(FileNotFoundError, match="step 7"):
        ckpt.restore(7, *_model_and_optimizer(9))
    # Saving a step again replaces its directory whole.
    model, opt = _model_and_optimizer(5)
    ckpt.save(2, model, opt, {"epoch_seed": 1, "counter": 0}, {})
    assert sorted(os.listdir(ckpt.step_dir(2))) == ["metadata.json", "model.safetensors", "optimizer.safetensors",
                                                     "sampler.json"]
    fresh = _model_and_optimizer(9)
    assert ckpt.restore(2, *fresh)[1] == {"epoch_seed": 1, "counter": 0}
    _assert_same(*fresh, model, opt)
    assert not [n for n in os.listdir(ckpt.directory) if n.startswith(".old")]


def test_optimizer_state_dict_roundtrip():
    model, opt = _model_and_optimizer(1)
    _, other = _model_and_optimizer(2)
    state = opt.state_dict()
    assert set(state["mu"]) == {p for p, _ in opt.params} and state["count"] == opt.count
    other.load_state_dict({"count": state["count"], "mu": {k: v.clone() for k, v in state["mu"].items()},
                           "nu": {k: v.clone() for k, v in state["nu"].items()}})
    _assert_same(model, other, model, opt)
    with pytest.raises(KeyError, match="missing"):
        other.load_state_dict({"count": 0, "mu": {}, "nu": state["nu"]})


def test_step_generator_depends_on_seed_and_step_only():
    draw = lambda seed, step: torch.rand(4, generator=step_generator(seed, step, "cpu"))
    assert torch.equal(draw(42, 3), draw(42, 3))
    assert not torch.equal(draw(42, 3), draw(42, 4)) and not torch.equal(draw(42, 3), draw(43, 3))
