"""The port's training entry point (``repro_torch.launch.train``) on the CPU:
auto-resume, checkpoints shared with the JAX package's ``launch.train`` in both
directions, the straggler monitor and the mesh flag.

* Resume: 4 steps straight equal 2 steps, a checkpoint and 2 more after
  a restart, bit for bit (losses and parameters).
* The JAX package's ``launch.train`` writes ``step_2`` of reduced
  smollm-135m; the port resumes from it for step 3, and the JAX package
  resumes the port's ``step_2`` the same way. Each side's step 3 is held
  against the other's: the same state and batch, so only AdamW's
  ``lr_t * m / sqrt(v)`` update differs by rounding; the parameters agree
  within ``2 * lr_3 + 1e-6`` (lr_3 = 6e-6 by the schedule).
* The checkpoint files hold the reference's layout: the port's
  ``step_2`` restores in ``repro.checkpoint.checkpointer`` into the
  reference's own ``(params, opt_state)`` (int32 ``step``) with every
  value equal, and back into a fresh port model bit for bit.
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.distributed.fault_tolerance import StragglerMonitor as JMonitor
from repro.launch import train as j_launch
from repro.models import lm as j_lm
from repro.models.train import make_train_step as j_make_train_step
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.launch import train as launch
from repro_torch.models import convert, lm
from repro_torch.models.train import make_train_step, named_params
from repro_torch.optim.adamw import cosine_schedule

ARCH = "smollm_135m"
RUN = dict(batch=4, seq=32, log_every=100)
CFG = reduced(get_arch(ARCH))
LR3 = float(cosine_schedule(3e-4, 200, 10000)(3))


def _port(steps, ckpt_dir=None, **kw):
    return launch.train(ARCH, steps=steps, ckpt_dir=ckpt_dir, device="cpu",
                        **RUN, **kw)


def _jax(steps, ckpt_dir):
    return j_launch.train(ARCH, steps=steps, ckpt_dir=str(ckpt_dir),
                          ckpt_every=2, **RUN)


def _reference_like():
    jcfg = j_reduced(j_get_arch(ARCH))
    jp = j_lm.init_params(jax.random.key(1), jcfg)
    return jp, j_make_train_step(jcfg)[0](jp)


def _state(tree):
    return convert.state_from_tree(jax.tree.map(np.asarray, tree))


def test_resume_is_bitwise(tmp_path):
    params, losses = _port(4)
    _, first = _port(2, tmp_path, ckpt_every=2)
    assert (tmp_path / "step_2" / "manifest.json").exists()
    resumed, rest = _port(4, tmp_path, ckpt_every=2)
    assert first + rest == losses
    for (name, a), b in zip(named_params(params).items(),
                            named_params(resumed).values()):
        assert torch.equal(a, b), name
    assert (tmp_path / "step_4").exists()


def _close(got: dict, expect: dict, rtol, atol, what):
    assert got.keys() == expect.keys()
    for name, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), expect[name].numpy(),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def test_checkpoints_cross_between_the_packages(tmp_path):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _jax(2, ref_dir)
    shutil.copytree(ref_dir, tmp_path / "ref_copy")
    jparams, _ = _jax(3, ref_dir)                       # the reference's step 3
    port_from_ref, _ = _port(3, tmp_path / "ref_copy")  # the port's step 3
    _close(named_params(port_from_ref), _state(jparams), 1e-6,
           2 * LR3 + 1e-6, "port resumed the reference")

    _port(2, port_dir, ckpt_every=2)
    like = _reference_like()
    (jp, jo), extra = jck.restore(port_dir, 2, like)
    assert int(jo.step) == 2 and jo.step.dtype == np.int32
    assert set(extra) == {"loss"}
    shutil.copytree(port_dir, tmp_path / "port_copy")
    port_params, _ = _port(3, port_dir)
    ref_from_port, _ = _jax(3, tmp_path / "port_copy")
    _close(named_params(port_params), _state(ref_from_port), 1e-6,
           2 * LR3 + 1e-6, "the reference resumed the port")


def test_port_checkpoint_holds_the_reference_tree(tmp_path):
    params, _ = _port(2, tmp_path, ckpt_every=2)
    (jp, jo), _ = jck.restore(tmp_path, 2, _reference_like())
    for name, t in named_params(params).items():
        assert np.array_equal(t.detach().numpy(), _state(jp)[name].numpy())
    fresh = lm.init_params(torch.Generator().manual_seed(9), CFG)
    opt_init = make_train_step(CFG)[0]
    fresh, opt = launch.restore(tmp_path, 2, fresh.requires_grad_(True),
                                opt_init(fresh))
    assert opt.step == 2
    for name, t in named_params(fresh).items():
        assert torch.equal(t, named_params(params)[name]), name
    for got, expect in ((opt.mu, jo.mu), (opt.nu, jo.nu)):
        for name, m in got.items():
            assert np.array_equal(m.numpy(), _state(expect)[name].numpy())


def test_straggler_monitor_matches_the_reference():
    rng = np.random.default_rng(0)
    times = rng.uniform(0.9, 1.1, (3, 12))
    times[2, 8:] = 3.0   # host 2 slows down for its last four steps
    port, ref = StragglerMonitor(3, window=8), JMonitor(3, window=8)
    for step in range(12):
        for host in range(3):
            port.end_step(host, float(times[host, step]))
            ref.end_step(host, float(times[host, step]))
        assert port.deadline() == ref.deadline()
        assert port.stragglers() == ref.stragglers()
    assert port.stragglers() == [2]
    port.start_step()
    port.end_step(0)
    assert 0 <= port.times[0][-1] < 1.0


def test_a_production_mesh_raises():
    """One process is a world of 1: the production meshes name the
    devices they need and how to launch that many."""
    with pytest.raises(RuntimeError, match=r"needs 256 devices, found 1; "
                       "launch with torchrun"):
        launch.main(["--mesh", "single", "--device", "cpu", "--steps", "1"])
    with pytest.raises(RuntimeError, match="needs 512 devices, found 1"):
        launch.main(["--mesh", "multi", "--device", "cpu", "--steps", "1"])
