"""Shared evaluation harness for all five algorithms (paper §IV), port of
``repro.core.evaluate``.

``rollout`` runs every episode at once, one environment each on the
leading axis (the reference ``vmap``s over episodes), and returns the
per-episode means; ``evaluate_policy`` averages them.
"""
from __future__ import annotations

import torch

from repro_torch.core import baselines, env as env_lib, maddpg
from repro_torch.core.types import EnvParams
from repro_torch.device import resolve_device


# --- policy adaptors: (params, gen, obs, p, cfg) -> Action --------------------
def policy_random(params, gen, obs, p, cfg):
    del params, cfg
    return baselines.random_policy(gen, obs, p)


def policy_greedy(params, gen, obs, p, cfg):
    del params, cfg
    return baselines.greedy_policy(gen, obs, p)


def policy_actor(params, gen, obs, p, cfg):
    obs = maddpg._mask_obs(obs, p, cfg.model_aware)
    return maddpg.policy_action(params, obs, p, cfg, gen, explore_scale=0.0)


def rollout(gen, policy_fn, params, p: EnvParams, cfg, episodes: int, *,
            device=None, start=None, tasks=None):
    """Run ``episodes`` deterministic episodes side by side; returns a dict
    of (episodes,) tensors, each metric's mean over the episode's steps.

    ``start`` (an ``EnvState`` with ``episodes`` environments) and
    ``tasks`` (one ``Task`` per step: the tasks drawn after it) replace
    the draws from ``gen``, so a test can replay another
    implementation's episodes."""
    device = resolve_device(device)
    state = (start if start is not None
             else env_lib.reset(gen, p, episodes, device=device))
    steps = {k: [] for k in ("reward", "latency", "energy", "completion",
                             "switch_latency")}
    for t in range(p.episode_len):
        obs = env_lib.observe(state, p)
        act = policy_fn(params, gen, obs, p, cfg)
        nxt = (tasks[t] if tasks is not None
               else env_lib.sample_tasks(gen, p, episodes, device))
        state, _, outcome, _ = env_lib.transition(state, act, p, nxt)
        steps["reward"].append(outcome.reward.sum(-1))
        steps["latency"].append(outcome.latency.mean(-1))
        steps["energy"].append(outcome.energy.mean(-1))
        steps["completion"].append(outcome.completed.mean(-1))
        steps["switch_latency"].append(outcome.switch_latency.mean(-1))
    return {k: torch.stack(v).mean(0) for k, v in steps.items()}


def evaluate_policy(gen, name: str, p: EnvParams, cfg=None, params=None,
                    episodes=32, *, device=None):
    """Convenience dispatcher; returns a python-float metric dict."""
    fn = {"random": policy_random, "greedy": policy_greedy,
          "actor": policy_actor}[name]
    if cfg is None:
        cfg = maddpg.AlgoConfig()
    out = rollout(gen, fn, params, p, cfg, episodes, device=device)
    return {k: float(v.mean()) for k, v in out.items()}
