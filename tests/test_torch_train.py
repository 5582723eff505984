"""The port's training path against the JAX package: the synthetic data
bit for bit, one train step (loss -> grad -> clip -> schedule -> update)
against JAX's ``make_train_step``, the loop's resume and watchdog, and
the launcher's flags.

Tolerances: batches bit-identical (numpy in both); after one SGD step
every parameter within 1e-6 of its largest |value| and the metrics within
rtol 1e-5 (gemma3-1b smoke at 2 layers; SGD keeps the update linear in
the gradient, so float32 order differences stay at their own size);
resumed and uninterrupted runs of the port bit-identical.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.configs import get_config as j_get_config
from repro.data import synthetic as jdata
from repro.train.optimizer import OptimizerConfig as JOC
from repro.train.step import TrainConfig as JTC
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import synthetic as tdata
from repro_torch.launch import train as launch
from repro_torch.models import lm as tlm
from repro_torch.train import step as tstep
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import OptimizerConfig as TOC
from repro_torch.utils.pytrees import flatten_with_paths


@pytest.mark.parametrize("kw", [dict(), dict(encdec=True, d_model=6),
                                dict(input_kind="embeds", d_model=5,
                                     seed=3, host_id=1)])
def test_synthetic_lm_batches_are_jax_bit_for_bit(kw):
    j = jdata.SyntheticLM(vocab_size=97, seq_len=12, batch_size=3, **kw)
    t = tdata.SyntheticLM(vocab_size=97, seq_len=12, batch_size=3,
                          device="cpu", **kw)
    for step in (0, 1, 17):
        bj, bt = j.batch_at(step), t.batch_at(step)
        assert sorted(bj) == sorted(bt)
        for k in bj:
            assert bt[k].dtype == torch.from_numpy(bj[k]).dtype, k
            np.testing.assert_array_equal(bt[k].numpy(), bj[k])


def test_synthetic_images_are_jax_bit_for_bit():
    j = jdata.SyntheticImages(num_classes=10, image_size=32, seed=4)
    t = tdata.SyntheticImages(num_classes=10, image_size=32, seed=4,
                              device="cpu")
    for split in ("train", "eval"):
        bj, bt = j.batch(8, 3, split), t.batch(8, 3, split)
        for k in ("images", "labels"):
            np.testing.assert_array_equal(bt[k].numpy(), bj[k])
    assert bt["images"].shape == (8, 32, 32, 3)


def test_one_train_step_matches_jax():
    """JAX's make_train_step (mesh None) and the port's on the same
    weights and batch: loss, clip and warmup schedule, the SGD update of
    every parameter, the step counter."""
    cj = j_get_config("gemma3-1b", smoke=True).replace(num_layers=2)
    ct = t_get_config("gemma3-1b", smoke=True).replace(num_layers=2)
    tc_j = JTC(lam=1e-3, lr=0.05, warmup=4, total_steps=20, clip_norm=0.5,
               opt=JOC(name="sgd"))
    tc_t = tstep.TrainConfig(lam=1e-3, lr=0.05, warmup=4, total_steps=20,
                             clip_norm=0.5, opt=TOC(name="sgd"))
    step_j, opt_j = j_make_train_step(cj, tc_j, None)
    from repro.train.step import init_state as j_init_state
    sj = j_init_state(cj, opt_j, jax.random.PRNGKey(0))
    step_t, opt_t = tstep.make_train_step(ct, tc_t)
    params = tlm.load_jax_arrays(_tree_to_arrays(sj["params"]), ct,
                                 device="cpu")
    st = tstep.state_from_params(params, opt_t)
    batch = tdata.SyntheticLM(ct.vocab_size, 16, 2, device="cpu").arrays_at(0)
    sj, mj = jax.jit(step_j)(sj, {k: jnp.asarray(v) for k, v in batch.items()})
    st, mt = step_t(st, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(st["step"]) == int(sj["step"]) == 1
    assert st["step"].dtype == torch.int32
    for k in ("loss", "ce", "reg", "grad_norm", "lr", "energy_uj"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(mj["grad_norm"]) > 0.5        # the clip is active
    jflat = _tree_to_arrays(sj["params"])
    for path, p in flatten_with_paths(st["params"]):
        a, b = p.detach().numpy(), jflat[path]
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), path
        assert p.requires_grad, path


def _small_run(tmp, steps, ckpt_every=2):
    cfg = t_get_config("gemma3-1b", smoke=True).replace(
        num_layers=1, d_model=32, d_ff=64, vocab_size=64)
    tcfg = tstep.TrainConfig(lr=1e-2, warmup=2, total_steps=8)
    step_fn, opt = tstep.make_train_step(cfg, tcfg)
    state = tstep.init_state(cfg, opt, 0, device="cpu")
    data = tdata.SyntheticLM(cfg.vocab_size, 8, 2, device="cpu")
    lcfg = LoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                      ckpt_dir=str(tmp), log_every=1,
                      metrics_path=os.path.join(tmp, "m.jsonl"))
    return state, step_fn, data.batch_at, lcfg


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Four steps in one run, and two + (restart) two from the checkpoint:
    the same parameters, optimizer state and step, bit for bit (the noise
    seed is the step, the batch a function of the step)."""
    state, step_fn, data_at, lcfg = _small_run(tmp_path / "a", 4)
    full, hist = train_loop(state, step_fn, data_at, lcfg, log=lambda m: 0)
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    state, step_fn, data_at, lcfg = _small_run(tmp_path / "b", 2)
    train_loop(state, step_fn, data_at, lcfg, log=lambda m: 0)
    logs = []
    state, step_fn, data_at, lcfg = _small_run(tmp_path / "b", 4)
    resumed, hist = train_loop(state, step_fn, data_at, lcfg,
                               log=logs.append)
    assert "[loop] resumed from step 2" in logs
    assert [h["step"] for h in hist] == [3, 4]
    for (pa, a), (pb, b) in zip(flatten_with_paths(full),
                                flatten_with_paths(resumed)):
        assert pa == pb and torch.equal(a, b), pa
    assert sorted(os.listdir(tmp_path / "b"))[-1] == "step_000000004"
    with open(tmp_path / "a" / "m.jsonl") as f:
        assert len(f.readlines()) == 4


def test_straggler_hook_fires(tmp_path):
    """A step slower than straggler_factor x the EWMA (after step 5) is
    reported through the hook."""
    def step_fn(state, batch):
        if int(state["step"]) == 7:
            time.sleep(0.3)
        return dict(state, step=state["step"] + 1), {"loss": 0.0}
    state = {"params": {"w": torch.zeros(2)}, "opt": {},
             "step": torch.zeros((), dtype=torch.int32)}
    fired = []
    train_loop(state, step_fn, lambda s: None,
               LoopConfig(total_steps=9, ckpt_every=100, ckpt_dir=str(tmp_path),
                          straggler_factor=3.0),
               straggler_hook=fired.append, log=lambda m: 0)
    assert any("[watchdog] step 7 took" in m for m in fired), fired


def test_launcher_trains_and_refuses_what_is_not_ported(tmp_path, monkeypatch,
                                                        capsys):
    ck = str(tmp_path)
    args = ["--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
            "--ckpt-dir", ck, "--ckpt-every", "1", "--opt", "sgd"]
    state, hist = launch.main(args, torch_device="cpu")
    assert int(state["step"]) == 2 and hist[-1]["step"] == 2
    assert np.isfinite(hist[-1]["loss"])
    assert os.path.exists(os.path.join(ck, "metrics.jsonl"))
    assert "final:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch.main(args + ["--placement", "mixed", "--device", "pcm"],
                    torch_device="cpu")
    assert "mutually exclusive" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="item 6"):
        launch.main(args + ["--rng", "threefry"], torch_device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        tstep.make_train_step(launch.setup(args, torch_device="cpu").cfg,
                              tstep.TrainConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="item 11"):
        tstep.jit_train_step()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="item 11"):
        launch.setup(args)


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        launch.setup(["--smoke"])
