"""MADDPG-MATO — Multi-Agent DDPG, Model-Aware Task Offloading (paper §III),
on tensors. Port of ``repro.core.maddpg``.

Each ED is an agent: actor ``v_m(o_m)`` emits (offload-target logits,
eta, beta); a centralised critic ``Q_m(s, a_1..a_M)`` scores joint
actions (eqs. 19-23). Per-agent networks are stacked parameter lists
applied as one batched product over the agent axis. Gradients come from
autograd; the optimiser is the reference's AdamW (``optim.adamw``).

The reference runs the training loop as one jitted ``lax.scan`` with a
``lax.cond`` per update; here ``train`` is a Python loop whose update
condition (step index, buffer fill) and episode ends are known on the
host, so it reads nothing back from the card while it runs.

Flags reproduce the paper's learned baselines:
  * ``centralized_critic=False``  -> SADDPG (independent DDPG per ED)
  * ``model_aware=False``         -> MADDPG-NoModel (compatibility masked
     from observations; download action forced off)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import env as env_lib
from repro_torch.core import networks, replay
from repro_torch.core.types import Action, EnvParams, action_dim, flat_action
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import adamw, apply_updates


class AlgoConfig(NamedTuple):
    hidden: int = 128
    critic_hidden: int = 256
    lr_actor: float = 1e-3        # paper: 0.001
    lr_critic: float = 1e-3
    gamma: float = 0.95           # paper: 0.95
    tau: float = 0.01             # paper: 0.01
    buffer_capacity: int = 10000  # paper: 10,000
    batch_size: int = 1024        # paper: 1024
    update_every: int = 10
    warmup: int = 1500
    explore_sigma: float = 0.15
    gumbel_scale: float = 1.0
    explore_decay_steps: int = 8000
    n_envs: int = 4
    total_steps: int = 12000
    centralized_critic: bool = True
    model_aware: bool = True


class TrainState(NamedTuple):
    actor: list
    critic: list
    target_actor: list
    target_critic: list
    actor_opt: object
    critic_opt: object
    step: torch.Tensor


def _mask_obs(obs, p: EnvParams, model_aware: bool):
    """MADDPG-NoModel cannot observe d_{m,i,n} (paper §IV.A)."""
    if model_aware:
        return obs
    k, n = p.num_models, p.num_ess
    start = k + 2 + n  # [type K | x | rho | f_es N | compat N | ...]
    mask = torch.ones((obs.shape[-1],), dtype=obs.dtype, device=obs.device)
    mask[start:start + n] = 0.0
    return obs * mask


def actor_sizes(p: EnvParams, cfg: AlgoConfig):
    return [env_lib.obs_dim(p), cfg.hidden, cfg.hidden, p.num_ess + 1 + 2]


def critic_in_dim(p: EnvParams, cfg: AlgoConfig):
    a = action_dim(p.num_ess)
    if cfg.centralized_critic:
        return (p.num_eds * env_lib.obs_dim(p) + env_lib.global_dim(p)
                + p.num_eds * a)
    return env_lib.obs_dim(p) + a


def critic_sizes(p: EnvParams, cfg: AlgoConfig):
    return [critic_in_dim(p, cfg), cfg.critic_hidden, cfg.critic_hidden, 1]


def init_state(gen, p: EnvParams, cfg: AlgoConfig, *, device=None) -> TrainState:
    """Fresh networks drawn from ``gen``, on ``device`` (``None``: the
    card)."""
    device = resolve_device(device)
    m = p.num_eds
    actor = networks.stacked_init(gen, m, actor_sizes(p, cfg),
                                  final_scale=0.1, device=device)
    critic = networks.stacked_init(gen, m, critic_sizes(p, cfg),
                                   final_scale=0.1, device=device)
    copy = lambda tree: networks.tree_map(torch.clone, tree)
    return TrainState(
        actor=actor,
        critic=critic,
        target_actor=copy(actor),
        target_critic=copy(critic),
        actor_opt=adamw(cfg.lr_actor)[0](actor),
        critic_opt=adamw(cfg.lr_critic)[0](critic),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


# --- action heads -------------------------------------------------------------
def _agents_apply(params, obs):
    """Stacked per-agent MLPs on (..., M, D) -> (..., M, out)."""
    return networks.stacked_apply(params, obs.movedim(-2, 0)).movedim(0, -2)


def _split_heads(out, num_ess: int):
    logits = out[..., : num_ess + 1]
    eta = torch.sigmoid(out[..., num_ess + 1])
    beta = torch.sigmoid(out[..., num_ess + 2])
    return logits, eta, beta


def draw_noise(gen, logits_shape, device):
    """The exploration draws of ``policy_action``: standard Gumbel noise
    over the target logits (``-log(-log(U))``, ``U`` kept off 0) and
    two standard normals over the agents (eta, beta)."""
    u = torch.rand(logits_shape, generator=gen, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    shape = logits_shape[:-1]
    return (gumbel, torch.randn(shape, generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device))


def policy_action(actor, obs, p: EnvParams, cfg: AlgoConfig, gen,
                  explore_scale, noise=None):
    """Executed (discrete) action with exploration noise; obs (..., M, D).

    ``noise`` = (gumbel, normal_eta, normal_beta) replaces the draws from
    ``gen``; ``explore_scale == 0`` draws nothing (the noise is scaled to
    zero either way)."""
    out = _agents_apply(actor, obs)  # (..., M, A_out)
    logits, eta, beta = _split_heads(out, p.num_ess)
    if noise is None and explore_scale != 0:
        noise = draw_noise(gen, logits.shape, logits.device)
    if noise is None:
        target = torch.argmax(logits, dim=-1)
        beta_prob = torch.clamp(beta, 0.0, 1.0)
        eta = torch.clamp(eta, 0.0, 1.0)
    else:
        gumbel, n_eta, n_beta = noise
        gumbel = gumbel * cfg.gumbel_scale
        target = torch.argmax(logits + gumbel * explore_scale, dim=-1)
        eta = torch.clamp(
            eta + explore_scale * cfg.explore_sigma * n_eta, 0.0, 1.0)
        beta_prob = torch.clamp(
            beta + explore_scale * cfg.explore_sigma * n_beta, 0.0, 1.0)
    beta_exec = (beta_prob > 0.5).to(torch.float32)
    if not cfg.model_aware:
        beta_exec = torch.zeros_like(beta_exec)
    return Action(target=target.to(torch.int32), eta=eta, beta=beta_exec)


def _soft_action(actor, obs, p: EnvParams, cfg: AlgoConfig):
    """Differentiable relaxed action vector (softmax over targets)."""
    out = _agents_apply(actor, obs)
    logits, eta, beta = _split_heads(out, p.num_ess)
    probs = torch.softmax(logits / cfg.gumbel_scale, dim=-1)
    if not cfg.model_aware:
        beta = torch.zeros_like(beta)
    return torch.cat([probs, eta[..., None], beta[..., None]], dim=-1)


# --- critic featurisation -----------------------------------------------------
def _critic_inputs(obs, gstate, acts, p: EnvParams, cfg: AlgoConfig):
    """Build the (M, B, X) critic input tensor.

    obs: (B, M, D)   gstate: (B, G)   acts: (B, M, A) or (M, B, M, A) for
    the per-agent actor-loss variant.
    """
    m = p.num_eds
    b = obs.shape[0]
    if cfg.centralized_critic:
        obs_flat = obs.reshape(b, -1)
        if acts.dim() == 3:
            act_flat = acts.reshape(b, -1)[None].expand(m, b,
                                                        m * acts.shape[-1])
        else:  # (M, B, M, A) — per-agent replaced joint actions
            act_flat = acts.reshape(m, b, -1)
        base = torch.cat([obs_flat, gstate], dim=-1)
        base = base[None].expand(m, b, base.shape[-1])
        return torch.cat([base, act_flat], dim=-1)
    # SADDPG: own obs + own action only
    own_obs = obs.transpose(0, 1)  # (M, B, D)
    if acts.dim() == 3:
        own_act = acts.transpose(0, 1)
    else:
        ar = torch.arange(m, device=acts.device)
        own_act = acts[ar, :, ar, :]
    return torch.cat([own_obs, own_act], dim=-1)


def _value_and_grad(loss_fn, params):
    """``jax.value_and_grad`` over a list-of-dicts parameter tree."""
    leaves = networks.tree_map(
        lambda t: t.detach().requires_grad_(True), params)
    flat = [layer[k] for layer in leaves for k in sorted(layer)]
    with torch.enable_grad():
        loss = loss_fn(leaves)
        grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), [{k: next(grads) for k in sorted(layer)}
                           for layer in leaves]


# --- one gradient update -------------------------------------------------------
def update(ts: TrainState, batch, p: EnvParams, cfg: AlgoConfig) -> TrainState:
    """One MADDPG step; returns the new state. ``update_losses`` also
    returns the two losses."""
    return update_losses(ts, batch, p, cfg)[0]


def update_losses(ts: TrainState, batch, p: EnvParams, cfg: AlgoConfig):
    """One MADDPG step: ``(TrainState, critic_loss, actor_loss)``."""
    obs, acts = batch["obs"], batch["act"]
    rew, done = batch["rew"], batch["done"]
    nobs, gstate, ngstate = batch["next_obs"], batch["gstate"], \
        batch["next_gstate"]
    m = p.num_eds

    # ---- critic target (eq. 19), held out of the gradient ----
    with torch.no_grad():
        next_act = _soft_action(ts.target_actor, nobs, p, cfg)  # (B, M, A)
        next_in = _critic_inputs(nobs, ngstate, next_act, p, cfg)
        q_next = networks.stacked_apply(ts.target_critic,
                                        next_in)[..., 0]        # (M, B)
        y = rew.transpose(0, 1) + cfg.gamma * (1.0 - done)[None, :] * q_next

    # ---- critic loss (eq. 20) ----
    critic_in = _critic_inputs(obs, gstate, acts, p, cfg)

    def critic_loss_fn(critic):
        q = networks.stacked_apply(critic, critic_in)[..., 0]
        return torch.mean(torch.square(q - y))

    c_loss, c_grads = _value_and_grad(critic_loss_fn, ts.critic)
    c_updates, c_opt = adamw(cfg.lr_critic)[1](c_grads, ts.critic_opt,
                                               ts.critic)
    critic = apply_updates(ts.critic, c_updates)

    # ---- actor loss (eq. 21): replace own slot with current-policy action,
    # scored by the UPDATED critic; only the actor takes this gradient ----
    eye = torch.eye(m, dtype=torch.bool, device=obs.device)[:, None, :, None]
    batch_joint = acts[None].expand((m,) + tuple(acts.shape))

    def actor_loss_fn(actor):
        cur = _soft_action(actor, obs, p, cfg)                  # (B, M, A)
        # joint actions per agent: (M, B, M, A); agent i's slot i is the
        # differentiable current-policy action, others come from the batch
        joint = torch.where(eye, cur[None].expand_as(batch_joint),
                            batch_joint)
        q = networks.stacked_apply(
            critic, _critic_inputs(obs, gstate, joint, p, cfg))[..., 0]
        return -torch.mean(q)

    a_loss, a_grads = _value_and_grad(actor_loss_fn, ts.actor)
    a_updates, a_opt = adamw(cfg.lr_actor)[1](a_grads, ts.actor_opt, ts.actor)
    actor = apply_updates(ts.actor, a_updates)

    # ---- soft target updates (eqs. 22-23) ----
    return TrainState(
        actor=actor,
        critic=critic,
        target_actor=networks.soft_update(ts.target_actor, actor, cfg.tau),
        target_critic=networks.soft_update(ts.target_critic, critic, cfg.tau),
        actor_opt=a_opt,
        critic_opt=c_opt,
        step=ts.step + 1,
    ), c_loss, a_loss


# --- full training loop ---------------------------------------------------------
def make_transition_example(p: EnvParams, cfg: AlgoConfig, *, device=None):
    d, g, a = env_lib.obs_dim(p), env_lib.global_dim(p), action_dim(p.num_ess)
    m = p.num_eds
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {
        "obs": z(m, d), "act": z(m, a), "rew": z(m),
        "next_obs": z(m, d), "done": z(), "gstate": z(g),
        "next_gstate": z(g),
    }


def train(gen, p: EnvParams, cfg: AlgoConfig, *, device=None):
    """Returns ``(TrainState, metrics)``: per-step tensors of the mean
    reward (summed over agents), latency, energy and completion.

    ``gen`` is a generator on ``device`` (``None``: the card); every draw
    (weights, environments, exploration, replay) comes from it."""
    device = resolve_device(device)
    ts = init_state(gen, p, cfg, device=device)
    env_states = env_lib.reset(gen, p, cfg.n_envs, device=device)
    buf = replay.init(cfg.buffer_capacity,
                      make_transition_example(p, cfg, device=device))
    obs = env_lib.observe(env_states, p)
    metrics = {k: [] for k in ("reward", "latency", "energy", "completion")}

    for step_idx in range(cfg.total_steps):
        explore = max(0.05, 1.0 - step_idx / cfg.explore_decay_steps)
        obs_in = _mask_obs(obs, p, cfg.model_aware)
        with torch.no_grad():
            actions = policy_action(ts.actor, obs_in, p, cfg, gen, explore)
        gstate = env_lib.global_state(env_states, p)
        nxt, nobs, outcome, done = env_lib.step(env_states, actions, p, gen)
        buf = replay.add_batch(buf, {
            "obs": obs_in,
            "act": flat_action(actions, p.num_ess),
            "rew": outcome.reward,
            "next_obs": _mask_obs(nobs, p, cfg.model_aware),
            "done": done.to(torch.float32),
            "gstate": gstate,
            "next_gstate": env_lib.global_state(nxt, p),
        }, cfg.n_envs)

        if step_idx % cfg.update_every == 0 and buf.size >= cfg.warmup:
            ts = update(ts, replay.sample(buf, gen, cfg.batch_size), p, cfg)

        # every environment starts at t = 0 and episodes share one
        # length, so all of them end on the same step
        if (step_idx + 1) % p.episode_len == 0:
            nxt = env_lib.auto_reset(nxt, done, p, gen)
            nobs = env_lib.observe(nxt, p)
        env_states, obs = nxt, nobs

        metrics["reward"].append(outcome.reward.sum(-1).mean())
        metrics["latency"].append(outcome.latency.mean())
        metrics["energy"].append(outcome.energy.mean())
        metrics["completion"].append(outcome.completed.mean())

    return ts, {k: torch.stack(v) if v else torch.zeros(0, device=device)
                for k, v in metrics.items()}
