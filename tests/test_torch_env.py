"""The port's environment (``repro_torch.core.env``) vs the JAX package's.

``jax.random`` has no bitwise counterpart in torch, so every comparison
feeds both sides the same draws: the reference resets and steps with its
keys, and the port's ``transition`` is handed the reference's state and
the tasks the reference drew for the next step. Integer and 0/1 fields
(task types, cache residency, LRU clocks, step counter, completion,
compatibility failures, done) are exact; floats are within float32
``rtol=1e-6`` (XLA and torch evaluate ``pow``/``log2`` of the radio
model to a few ulps of each other).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core.types import Action as JAction
from repro_torch.core import env as tenv
from repro_torch.core.types import Action, EnvState, Task

RTOL = 1e-6
INT_OUT = ("completed", "failed_compat")
FLOAT_OUT = ("latency", "energy", "reward", "switch_latency")


def _port_state(s):
    """A reference EnvState (one environment) as the port's, E = 1."""
    t = lambda x: torch.as_tensor(np.array(x))[None]
    return EnvState(t=t(s.t), ed_pos=t(s.ed_pos), es_pos=t(s.es_pos),
                    cc_pos=t(s.cc_pos), f_ed=t(s.f_ed), cache=t(s.cache),
                    last_use=t(s.last_use),
                    task=Task(mu=t(s.task.mu), x_bits=t(s.task.x_bits),
                              rho=t(s.task.rho)))


def _port_action(target, eta, beta):
    return Action(target=torch.as_tensor(target, dtype=torch.int32)[None],
                  eta=torch.as_tensor(eta, dtype=torch.float32)[None],
                  beta=torch.as_tensor(beta, dtype=torch.float32)[None])


def _same_state(got, ref, where):
    assert torch.equal(got.t[0], torch.as_tensor(np.array(ref.t))), where
    for k in ("cache", "last_use"):
        assert np.array_equal(getattr(got, k)[0].numpy(),
                              np.asarray(getattr(ref, k))), f"{where}: {k}"
    assert np.array_equal(got.task.mu[0].numpy(), np.asarray(ref.task.mu))


def _same_outcome(got, ref, where):
    for k in INT_OUT:
        assert np.array_equal(getattr(got, k)[0].numpy(),
                              np.asarray(getattr(ref, k))), f"{where}: {k}"
    for k in FLOAT_OUT:
        np.testing.assert_allclose(getattr(got, k)[0].numpy(),
                                   np.asarray(getattr(ref, k)), rtol=RTOL,
                                   atol=0.0, err_msg=f"{where}: {k}")


@pytest.mark.parametrize("kw", [
    {}, dict(num_eds=7, num_models=5, num_ess=4, key=3),
    dict(faithful=True, num_cells=2), dict(num_ess=3, num_cells=3)])
def test_default_params_equal_field_for_field(kw):
    assert tenv.default_params(**kw)._asdict() == \
        jenv.default_params(**kw)._asdict()


def test_default_params_rejects_cells_without_servers():
    with pytest.raises(ValueError, match="no edge server"):
        tenv.default_params(num_ess=2, num_cells=3)


def test_lru_keep_ties_and_free_slots_exact():
    rng = np.random.default_rng(0)
    cache = (rng.random((64, 6)) < 0.6).astype(np.float32)
    # few distinct clocks: many equal last_use values among residents
    last = rng.integers(0, 3, (64, 6)).astype(np.int32)
    cache[0] = 0.0          # an empty server
    cache[1] = 1.0          # a full row with every clock tied
    last[1] = 2
    for slots in (1, 2, 3):
        expect = jax.vmap(lambda c, l: jenv.lru_keep(c, l, slots))(
            jnp.asarray(cache), jnp.asarray(last))
        got = tenv.lru_keep(torch.as_tensor(cache), torch.as_tensor(last),
                            slots)
        assert np.array_equal(got.numpy(), np.asarray(expect)), slots


def test_fifo_load_exact():
    rng = np.random.default_rng(1)
    es = rng.integers(0, 4, (5, 9)).astype(np.int32)
    off = rng.random((5, 9)) < 0.5
    expect = jax.vmap(lambda e, o: jenv.fifo_load(e, o, 4))(
        jnp.asarray(es), jnp.asarray(off))
    got = tenv.fifo_load(torch.as_tensor(es), torch.as_tensor(off), 4)
    assert np.array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("num_cells", [1, 2])
def test_observe_and_global_state(num_cells):
    p = jenv.default_params(num_eds=10, num_models=4, num_ess=3,
                            num_cells=num_cells)
    s = jenv.reset(jax.random.key(11), p)
    ts = _port_state(s)
    obs = tenv.observe(ts, p)
    assert obs.shape == (1, 10, tenv.obs_dim(p)) and \
        tenv.obs_dim(p) == jenv.obs_dim(p)
    np.testing.assert_allclose(obs[0].numpy(), np.asarray(jenv.observe(s, p)),
                               rtol=RTOL, atol=0.0)
    assert np.array_equal(tenv.global_state(ts, p)[0].numpy(),
                          np.asarray(jenv.global_state(s, p)))
    assert tenv.global_dim(p) == jenv.global_dim(p)


# --- the crafted single-ED sequence (after tests/test_partial_offload.py):
# one ED, two servers holding {0, 1} and {1, 2}, power-of-two sizes
X_BITS = [2.0 ** 23, 2.0 ** 22, 2.0 ** 24]
RHO = [2.0 ** 6, 2.0 ** 5, 2.0 ** 7]
SEQUENCE = [  # (model, x, rho, es target (1-based), eta, beta)
    (0, X_BITS[0], RHO[0], 1, 0.5, True),    # hit on es0 (model 0)
    (1, X_BITS[1], RHO[1], 1, 1.0, True),    # hit on es0 (model 1)
    (2, X_BITS[2], RHO[2], 1, 0.25, True),   # miss -> download, evict
    (2, X_BITS[0], RHO[1], 2, 0.75, True),   # hit on es1 (model 2)
    (0, X_BITS[1], RHO[2], 2, 0.5, True),    # miss -> download on es1
    (1, X_BITS[2], RHO[0], 1, 1.0, True),    # post-eviction revisit
    (2, X_BITS[1], RHO[1], 2, 0.5, False),   # refused hit
    (1, X_BITS[0], RHO[0], 2, 0.5, False),   # refused miss: failed_compat
]


def test_crafted_single_ed_sequence():
    p = jenv.default_params(num_eds=1, num_models=3, num_ess=2)
    p = p._replace(model_bits=(2.0 ** 30, 2.0 ** 31, 2.0 ** 29),
                   f_es=2.0 ** 33, deadline=(64.0,) * 3)
    s = jenv.reset(jax.random.key(0), p)
    s = s._replace(f_ed=jnp.full((1,), 2.0 ** 31, jnp.float32),
                   cache=jnp.asarray([[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]],
                                     jnp.float32),
                   last_use=jnp.zeros((2, 3), jnp.int32))
    ts = _port_state(s)
    for i, (m, x, rho, tgt, eta, beta) in enumerate(SEQUENCE):
        task = dict(mu=jnp.asarray([m], jnp.int32),
                    x_bits=jnp.asarray([x], jnp.float32),
                    rho=jnp.asarray([rho], jnp.float32))
        s = s._replace(task=s.task._replace(**task))
        ts = ts._replace(task=Task(**{k: torch.as_tensor(np.array(v))[None]
                                      for k, v in task.items()}))
        act = (np.array([tgt], np.int32), np.array([eta], np.float32),
               np.array([1.0 if beta else 0.0], np.float32))
        s2, obs, out, done = _jit_step(p)(s, JAction(*map(jnp.asarray, act)))
        ts2, tobs, tout, tdone = tenv.transition(
            ts, _port_action(*act), p, _port_state(s2).task)
        _same_outcome(tout, out, f"step {i}")
        _same_state(ts2, s2, f"step {i}")
        np.testing.assert_allclose(tobs[0].numpy(), np.asarray(obs),
                                   rtol=RTOL, atol=0.0)
        assert bool(tdone[0]) == bool(done)
        s, ts = s2, ts2
    assert float(out.failed_compat[0]) == 1.0     # the refused miss


@functools.lru_cache(maxsize=None)
def _jit_step(p):
    return jax.jit(lambda s, a: jenv.step(s, a, p))


@pytest.mark.parametrize("num_cells", [1, 2])
@pytest.mark.parametrize("faithful", [False, True])
def test_whole_episode_matches_reference(faithful, num_cells):
    p = jenv.default_params(num_eds=10, num_models=4, num_ess=3,
                            faithful=faithful, num_cells=num_cells)
    rng = np.random.default_rng([num_cells, int(faithful)])
    steps = p.episode_len
    targets = rng.integers(0, p.num_ess + 1, (steps, p.num_eds)).astype(
        np.int32)
    etas = rng.choice([0.0, 0.0005, 0.3, 0.7, 1.0], (steps, p.num_eds))
    etas = np.where(rng.random((steps, p.num_eds)) < 0.5,
                    rng.random((steps, p.num_eds)), etas).astype(np.float32)
    betas = (rng.random((steps, p.num_eds)) < 0.6).astype(np.float32)
    s = jenv.reset(jax.random.key(100 + num_cells), p)
    ts = _port_state(s)
    step = _jit_step(p)
    downloads = 0
    for i in range(steps):
        act = (targets[i], etas[i], betas[i])
        s2, obs, out, done = step(s, JAction(*map(jnp.asarray, act)))
        ts2, tobs, tout, tdone = tenv.transition(
            ts, _port_action(*act), p, _port_state(s2).task)
        _same_outcome(tout, out, f"step {i}")
        _same_state(ts2, s2, f"step {i}")
        np.testing.assert_allclose(tobs[0].numpy(), np.asarray(obs),
                                   rtol=RTOL, atol=0.0, err_msg=f"step {i}")
        assert bool(tdone[0]) == bool(done) == (i == steps - 1)
        downloads += int((np.asarray(out.switch_latency) > 0).sum())
        s, ts = s2, ts2
    assert downloads > 0          # the episode exercised the eviction path


def test_batched_environments_step_independently():
    """A leading environment axis of 3 gives each environment the step
    it would take alone."""
    p = jenv.default_params(num_eds=6, num_models=4, num_ess=3)
    gen = torch.Generator().manual_seed(5)
    batch = tenv.reset(gen, p, 3, device="cpu")
    act = Action(target=torch.randint(0, 4, (3, 6), generator=gen,
                                      dtype=torch.int32),
                 eta=torch.rand((3, 6), generator=gen),
                 beta=(torch.rand((3, 6), generator=gen) > 0.5).float())
    nxt_task = tenv.sample_tasks(gen, p, 3)
    whole, wobs, wout, _ = tenv.transition(batch, act, p, nxt_task)
    for e in range(3):
        pick = lambda tree: type(tree)(*(
            pick(x) if isinstance(x, tuple) else x[e:e + 1] for x in tree))
        one, oobs, oout, _ = tenv.transition(pick(batch), pick(act), p,
                                             pick(nxt_task))
        for a, b in zip(oout, wout):
            assert torch.equal(a[0], b[e])
        assert torch.equal(one.cache[0], whole.cache[e])
        assert torch.equal(oobs[0], wobs[e])


def test_reset_step_and_auto_reset():
    p = jenv.default_params(num_eds=5, num_models=4, num_ess=3)
    gen = torch.Generator().manual_seed(2)
    s = tenv.reset(gen, p, 3, device="cpu")
    assert s.cache.sum(-1).eq(p.cache_slots).all()
    assert ((s.task.mu >= 0) & (s.task.mu < p.num_models)).all()
    assert ((s.task.x_bits >= 2.0 * 8e6) & (s.task.x_bits <= 20.0 * 8e6)).all()
    assert ((s.ed_pos >= 0) & (s.ed_pos <= p.area_m)).all()
    act = Action(target=torch.full((3, 5), 1, dtype=torch.int32),
                 eta=torch.ones(3, 5), beta=torch.ones(3, 5))
    for _ in range(p.episode_len):
        s, obs, out, done = tenv.step(s, act, p, gen)
    assert done.all() and obs.shape == (3, 5, tenv.obs_dim(p))
    mixed = torch.tensor([True, False, True])
    r = tenv.auto_reset(s, mixed, p, gen)
    assert r.t.tolist() == [0, p.episode_len, 0]
    assert torch.equal(r.cache[1], s.cache[1])
    assert torch.equal(r.ed_pos[1], s.ed_pos[1])
    assert torch.equal(r.task.mu[1], s.task.mu[1])
    assert not r.last_use[0].any() and not r.last_use[2].any()
    assert r.cache[[0, 2]].sum(-1).eq(p.cache_slots).all()
    assert not torch.equal(r.ed_pos[0], s.ed_pos[0])
