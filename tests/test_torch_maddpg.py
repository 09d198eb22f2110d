"""The port's MADDPG-MATO plane (maddpg, replay, adamw, baselines,
evaluate) vs the JAX package's, on identical inputs.

Every random draw the reference makes (exploration noise, replay
indices, environment tasks) is made by the reference and handed to the
port: the two never draw independently. The parameters and optimiser
moments come across through ``networks.params_from_numpy``. One
``update`` agrees with ``jax.value_and_grad`` plus the reference AdamW
within float32 ``rtol=1e-5, atol=1e-6`` (losses, parameters, target
parameters, moments); the building blocks within ``rtol=1e-6`` or
exactly where they only move data.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import env as jenv
from repro.core import evaluate as jeval
from repro.core import maddpg as jm
from repro.core import networks as jnet
from repro.core import replay as jreplay
from repro.core.types import Action as JAction
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.core import baselines as tbase
from repro_torch.core import evaluate as teval
from repro_torch.core import maddpg as tm
from repro_torch.core import networks as tnet
from repro_torch.core import replay as treplay
from repro_torch.core.types import EnvState, Task
from repro_torch.optim import adamw as tadamw

# the package re-exports the function ``adamw`` under the module's name
jadamw = importlib.import_module("repro.optim.adamw")

P = jenv.default_params(num_eds=3, num_models=3, num_ess=2)
CFG = jm.AlgoConfig(hidden=16, critic_hidden=32, batch_size=32)
TCFG = tm.AlgoConfig(**CFG._asdict())
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_opt(opt):
    return tadamw.OptState(step=int(opt.step),
                           mu=tnet.params_from_numpy(_np(opt.mu)),
                           nu=tnet.params_from_numpy(_np(opt.nu)))


def _port_ts(ts):
    nets = {k: tnet.params_from_numpy(_np(getattr(ts, k)))
            for k in ("actor", "critic", "target_actor", "target_critic")}
    return tm.TrainState(**nets, actor_opt=_port_opt(ts.actor_opt),
                         critic_opt=_port_opt(ts.critic_opt),
                         step=_t(ts.step))


def _close_tree(got, ref, what, rtol=RTOL, atol=ATOL):
    ref_leaves = jax.tree.leaves(_np(ref))
    got_leaves = list(tck._flatten(got).values())   # JAX's leaf order
    assert len(got_leaves) == len(ref_leaves), what
    for g, r in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=rtol,
                                   atol=atol, err_msg=what)


def _batch(seed, b=32, p=P):
    rng = np.random.default_rng(seed)
    m, d, g = p.num_eds, jenv.obs_dim(p), jenv.global_dim(p)
    a = p.num_ess + 3
    onehot = np.eye(p.num_ess + 1)[rng.integers(0, p.num_ess + 1, (b, m))]
    act = np.concatenate([onehot, rng.random((b, m, 1)),
                          (rng.random((b, m, 1)) < 0.5)], axis=-1)
    assert act.shape[-1] == a
    batch = {
        "obs": rng.random((b, m, d)), "act": act,
        "rew": rng.normal(-2.0, 1.0, (b, m)),
        "next_obs": rng.random((b, m, d)),
        "done": (rng.random(b) < 0.1).astype(float),
        "gstate": (rng.random((b, g)) < 0.5).astype(float),
        "next_gstate": (rng.random((b, g)) < 0.5).astype(float),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


def test_config_and_sizes_match_reference():
    assert tm.AlgoConfig()._asdict() == jm.AlgoConfig()._asdict()
    for central in (True, False):
        cfg = CFG._replace(centralized_critic=central)
        tcfg = TCFG._replace(centralized_critic=central)
        assert tm.actor_sizes(P, tcfg) == jm.actor_sizes(P, cfg)
        assert tm.critic_sizes(P, tcfg) == jm.critic_sizes(P, cfg)


def test_split_heads_and_soft_action():
    jactor = jnet.stacked_init(jax.random.key(1), P.num_eds,
                               jm.actor_sizes(P, CFG))
    actor = tnet.params_from_numpy(_np(jactor))
    obs = np.random.default_rng(2).random((5, P.num_eds, jenv.obs_dim(P)),
                                          ).astype(np.float32)
    out = np.random.default_rng(3).normal(0, 3, (5, P.num_eds, 6)).astype(
        np.float32)
    for g, r in zip(tm._split_heads(_t(out), P.num_ess),
                    jm._split_heads(jnp.asarray(out), P.num_ess)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    for aware in (True, False):
        got = tm._soft_action(actor, _t(obs), P,
                              TCFG._replace(model_aware=aware))
        ref = jax.jit(jax.vmap(lambda o: jm._soft_action(
            jactor, o, P, CFG._replace(model_aware=aware))))(jnp.asarray(obs))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("central", [True, False])
def test_critic_inputs_both_critics(central):
    b = _batch(4, b=6)
    cfg, tcfg = (CFG._replace(centralized_critic=central),
                 TCFG._replace(centralized_critic=central))
    joint = np.random.default_rng(5).random(
        (P.num_eds, 6, P.num_eds, 6)).astype(np.float32)
    for acts in (b["act"], joint):
        got = tm._critic_inputs(_t(b["obs"]), _t(b["gstate"]), _t(acts),
                                P, tcfg)
        ref = jm._critic_inputs(jnp.asarray(b["obs"]),
                                jnp.asarray(b["gstate"]), jnp.asarray(acts),
                                P, cfg)
        assert got.shape == ref.shape
        assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("explore", [1.0, 0.3])
@pytest.mark.parametrize("aware", [True, False])
def test_policy_action_on_injected_noise(explore, aware):
    cfg, tcfg = CFG._replace(model_aware=aware), TCFG._replace(
        model_aware=aware)
    jactor = jnet.stacked_init(jax.random.key(6), P.num_eds,
                               jm.actor_sizes(P, CFG))
    obs = np.random.default_rng(7).random((P.num_eds, jenv.obs_dim(P))
                                          ).astype(np.float32)
    key = jax.random.key(8)
    ref = jm.policy_action(jactor, jnp.asarray(obs), P, cfg, key, explore)
    k_g, k_e, k_b = jax.random.split(key, 3)      # the reference's draws
    noise = (jax.random.gumbel(k_g, (P.num_eds, P.num_ess + 1)),
             jax.random.normal(k_e, (P.num_eds,)),
             jax.random.normal(k_b, (P.num_eds,)))
    got = tm.policy_action(tnet.params_from_numpy(_np(jactor)), _t(obs), P,
                           tcfg, None, explore,
                           noise=tuple(_t(n) for n in noise))
    assert np.array_equal(got.target.numpy(), np.asarray(ref.target))
    assert np.array_equal(got.beta.numpy(), np.asarray(ref.beta))
    np.testing.assert_allclose(got.eta.numpy(), np.asarray(ref.eta),
                               rtol=1e-6, atol=1e-7)
    # without exploration no noise is drawn, and the argmax is the same
    zero = tm.policy_action(tnet.params_from_numpy(_np(jactor)), _t(obs), P,
                            tcfg, None, 0.0)
    zref = jm.policy_action(jactor, jnp.asarray(obs), P, cfg, key, 0.0)
    assert np.array_equal(zero.target.numpy(), np.asarray(zref.target))


def test_draw_noise_is_finite_gumbel():
    gen = torch.Generator().manual_seed(0)
    g, e, b = tm.draw_noise(gen, (4096, 3), "cpu")
    assert torch.isfinite(g).all() and e.shape == b.shape == (4096,)
    # standard Gumbel: mean = Euler's constant, variance = pi^2 / 6
    assert abs(float(g.mean()) - 0.5772) < 0.05
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.1


@pytest.mark.parametrize("central", [True, False])
def test_update_matches_reference(central):
    cfg = CFG._replace(centralized_critic=central)
    tcfg = TCFG._replace(centralized_critic=central)
    update = jax.jit(lambda ts, b: jm.update(ts, b, None, P, cfg))
    jts = jm.init_state(jax.random.key(9), P, cfg)
    # a first update leaves moments, targets and the step counter non-trivial
    jts = update(jts, jax.tree.map(jnp.asarray, _batch(10)))
    batch = _batch(11)
    ts = _port_ts(jts)
    jbatch = jax.tree.map(jnp.asarray, batch)

    # the reference's losses, by its own building blocks
    next_act = jax.vmap(lambda o: jm._soft_action(jts.target_actor, o, P,
                                                  cfg))(jbatch["next_obs"])
    q_next = jnet.stacked_apply(jts.target_critic, jm._critic_inputs(
        jbatch["next_obs"], jbatch["next_gstate"], next_act, P, cfg))[..., 0]
    y = (jnp.swapaxes(jbatch["rew"], 0, 1)
         + cfg.gamma * (1.0 - jbatch["done"])[None, :] * q_next)
    q = jnet.stacked_apply(jts.critic, jm._critic_inputs(
        jbatch["obs"], jbatch["gstate"], jbatch["act"], P, cfg))[..., 0]
    ref_c_loss = float(jnp.mean(jnp.square(q - y)))

    jnew = update(jts, jbatch)
    cur = jax.vmap(lambda o: jm._soft_action(jts.actor, o, P, cfg))(
        jbatch["obs"])
    eye = jnp.eye(P.num_eds, dtype=bool)[:, None, :, None]
    joint = jnp.where(eye, cur[None], jbatch["act"][None])
    ref_a_loss = -float(jnp.mean(jnet.stacked_apply(
        jnew.critic, jm._critic_inputs(jbatch["obs"], jbatch["gstate"],
                                       joint, P, cfg))[..., 0]))

    new, c_loss, a_loss = tm.update_losses(
        ts, {k: _t(v) for k, v in batch.items()}, P, tcfg)
    np.testing.assert_allclose(float(c_loss), ref_c_loss, rtol=RTOL)
    np.testing.assert_allclose(float(a_loss), ref_a_loss, rtol=RTOL)
    for k in ("actor", "critic", "target_actor", "target_critic"):
        _close_tree(getattr(new, k), getattr(jnew, k), k)
    for k in ("actor_opt", "critic_opt"):
        got, ref = getattr(new, k), getattr(jnew, k)
        assert int(got.step) == int(ref.step) == 2
        _close_tree(got.mu, ref.mu, f"{k}.mu")
        _close_tree(got.nu, ref.nu, f"{k}.nu", atol=1e-9)
    assert int(new.step) == int(jnew.step) == 2


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_matches_reference_for_five_steps(wd):
    rng = np.random.default_rng(12)
    params = [{"w": rng.normal(size=(4, 5)).astype(np.float32),
               "b": rng.normal(size=(5,)).astype(np.float32)}]
    jinit, jupd = jadamw.adamw(1e-2, weight_decay=wd)
    tinit, tupd = tadamw.adamw(1e-2, weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tnet.params_from_numpy(params)
    jst, tst = jinit(jp), tinit(tp)
    for i in range(5):
        g = [{"w": rng.normal(size=(4, 5)).astype(np.float32),
              "b": (rng.normal(size=(5,)) * 10.0 ** -i).astype(np.float32)}]
        ju, jst = jupd(jax.tree.map(jnp.asarray, g), jst, jp)
        tu, tst = tupd(tnet.params_from_numpy(g), tst, tp)
        jp = jadamw.apply_updates(jp, ju)
        tp = tadamw.apply_updates(tp, tu)
        _close_tree(tu, ju, f"updates {i}", rtol=1e-6, atol=1e-9)
        _close_tree(tp, jp, f"params {i}", rtol=1e-6, atol=1e-9)
        _close_tree(tst.mu, jst.mu, f"mu {i}", rtol=1e-6, atol=1e-9)
        _close_tree(tst.nu, jst.nu, f"nu {i}", rtol=1e-6, atol=1e-12)
        assert int(tst.step) == int(jst.step) == i + 1


def test_clip_and_cosine_schedule_match_reference():
    rng = np.random.default_rng(13)
    g = [{"w": rng.normal(size=(3, 3)).astype(np.float32)}]
    jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    tc, tn = tadamw.clip_by_global_norm(tnet.params_from_numpy(g), 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close_tree(tc, jc, "clipped", rtol=1e-6)
    js = jadamw.cosine_schedule(1e-3, 10, 100)
    ts = tadamw.cosine_schedule(1e-3, 10, 100)
    for step in (0, 5, 10, 50, 100, 150):
        np.testing.assert_allclose(float(ts(step)), float(js(step)),
                                   rtol=1e-6)


def test_replay_with_injected_indices():
    example = jm.make_transition_example(P, CFG)
    jbuf = jreplay.init(7, example)
    tbuf = treplay.init(7, tm.make_transition_example(P, TCFG, device="cpu"))
    for i in range(4):                  # 12 items through 7 slots: wraps
        items = {k: v[:3] for k, v in _batch(20 + i, b=3).items()}
        jbuf = jreplay.add_batch(jbuf, jax.tree.map(jnp.asarray, items), 3)
        tbuf = treplay.add_batch(tbuf, {k: _t(v) for k, v in items.items()},
                                 3)
        assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))
        for k in example:
            assert np.array_equal(tbuf.data[k].numpy(),
                                  np.asarray(jbuf.data[k])), k
    key = jax.random.key(21)
    ref = jreplay.sample(jbuf, key, 16)
    idx = jax.random.randint(key, (16,), 0, max(int(jbuf.size), 1))
    got = treplay.sample(tbuf, None, 16, idx=_t(idx).long())
    for k in example:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    drawn = treplay.sample(tbuf, torch.Generator().manual_seed(0), 64)
    assert drawn["obs"].shape == (64, P.num_eds, jenv.obs_dim(P))


def test_short_train_gives_finite_metrics():
    p = jenv.default_params(num_eds=3, num_models=3, num_ess=2)
    cfg = TCFG._replace(n_envs=2, total_steps=60, warmup=64,
                        buffer_capacity=256, update_every=5)
    ts, metrics = tm.train(torch.Generator().manual_seed(0), p, cfg,
                           device="cpu")
    # the buffer holds 64 items after step 31: updates at 35, 40, ..., 55
    assert int(ts.step) == 5
    assert int(ts.actor_opt.step) == int(ts.critic_opt.step) == 5
    for k, v in metrics.items():
        assert v.shape == (60,) and torch.isfinite(v).all(), k
    assert ((metrics["completion"] >= 0) & (metrics["completion"] <= 1)).all()


def test_baselines_on_identical_obs():
    p = jenv.default_params(num_eds=8, num_models=3, num_ess=3, num_cells=3)
    states = [jenv.reset(jax.random.key(i), p) for i in range(4)]
    obs = np.stack([np.asarray(jenv.observe(s, p)) for s in states])
    ref = [jbase.greedy_policy(None, jnp.asarray(o), p) for o in obs]
    got = tbase.greedy_policy(None, _t(obs), p)
    for f in ("target", "eta", "beta"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.stack([np.asarray(getattr(r, f))
                                        for r in ref])), f
    rnd = tbase.random_policy(torch.Generator().manual_seed(1), _t(obs), p)
    jrnd = jbase.random_policy(jax.random.key(1), jnp.asarray(obs[0]), p)
    assert rnd.target.shape == (4, 8) and rnd.target.dtype == torch.int32
    assert str(jrnd.target.dtype) == "int32"
    assert ((rnd.target >= 0) & (rnd.target <= p.num_ess)).all()
    assert ((rnd.eta >= 0) & (rnd.eta < 1)).all()
    assert set(rnd.beta.unique().tolist()) <= {0.0, 1.0}


def _reference_episodes(key, policy_fn, params, p, cfg, episodes):
    """The reference's rollout, episode by episode with its own keys:
    the per-episode metric means, each episode's start state and the
    tasks it drew after every step."""
    metrics, starts, tasks = [], [], []
    @jax.jit
    def step(params, s, k_run):
        k_run, k_act = jax.random.split(k_run)
        act = policy_fn(params, k_act, jenv.observe(s, p), p, cfg)
        s, _, out, _ = jenv.step(s, act, p)
        return s, out, k_run

    for k in jax.random.split(key, episodes):
        k_reset, k_run = jax.random.split(k)
        s = jenv.reset(k_reset, p)
        starts.append(s)
        ep, drawn = [], []
        for _ in range(p.episode_len):
            s, out, k_run = step(params, s, k_run)
            drawn.append(s.task)
            ep.append([float(out.reward.sum()), float(out.latency.mean()),
                       float(out.energy.mean()), float(out.completed.mean())])
        metrics.append(np.mean(ep, axis=0))
        tasks.append(drawn)
    return np.array(metrics), starts, tasks


@pytest.mark.parametrize("name", ["greedy", "actor"])
def test_rollout_with_reference_tasks(name):
    # short episodes keep the reference's per-step loop quick
    p = jenv.default_params(num_eds=4, num_models=3, num_ess=3)._replace(
        episode_len=12)
    episodes = 3
    jactor = jnet.stacked_init(jax.random.key(30), p.num_eds,
                               jm.actor_sizes(p, CFG), final_scale=0.1)
    jfn = {"greedy": jeval.policy_greedy, "actor": jeval.policy_actor}[name]
    tfn = {"greedy": teval.policy_greedy, "actor": teval.policy_actor}[name]
    params = jactor if name == "actor" else None
    key = jax.random.key(31)
    ref, starts, tasks = _reference_episodes(key, jfn, params, p, CFG,
                                             episodes)
    # the replication is the reference's rollout
    whole = jeval.rollout(key, jfn, params, p, CFG, episodes)
    np.testing.assert_allclose(ref.mean(0), [float(whole[k]) for k in (
        "reward", "latency", "energy", "completion")], rtol=1e-5)

    stack = lambda xs: torch.as_tensor(np.stack([np.asarray(x) for x in xs]))
    start = EnvState(
        t=stack([s.t for s in starts]), ed_pos=stack([s.ed_pos for s in starts]),
        es_pos=stack([s.es_pos for s in starts]),
        cc_pos=stack([s.cc_pos for s in starts]),
        f_ed=stack([s.f_ed for s in starts]),
        cache=stack([s.cache for s in starts]),
        last_use=stack([s.last_use for s in starts]),
        task=Task(*(stack([getattr(s.task, f) for s in starts])
                    for f in Task._fields)))
    per_step = [Task(*(stack([getattr(tasks[e][t], f)
                              for e in range(episodes)])
                       for f in Task._fields))
                for t in range(p.episode_len)]
    tparams = tnet.params_from_numpy(_np(jactor)) if name == "actor" else None
    got = teval.rollout(None, tfn, tparams, p, TCFG, episodes, device="cpu",
                        start=start, tasks=per_step)
    for j, k in enumerate(("reward", "latency", "energy", "completion")):
        np.testing.assert_allclose(got[k].numpy(), ref[:, j], rtol=1e-5,
                                   err_msg=k)


def test_evaluate_policy_runs_each_policy():
    p = jenv.default_params(num_eds=3, num_models=3, num_ess=2)
    gen = torch.Generator().manual_seed(3)
    ts = tm.init_state(gen, p, TCFG, device="cpu")
    for name in ("random", "greedy", "actor"):
        out = teval.evaluate_policy(gen, name, p, TCFG, ts.actor, episodes=4,
                                    device="cpu")
        assert sorted(out) == sorted(["reward", "latency", "energy",
                                      "completion", "switch_latency"])
        assert all(np.isfinite(v) for v in out.values())
        assert 0.0 <= out["completion"] <= 1.0
