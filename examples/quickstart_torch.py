"""Quickstart through the PyTorch port: train MADDPG-MATO on the paper's
IIoT offloading environment and compare it against the random and greedy
baselines (paper §IV). Counterpart of ``quickstart.py`` (whose
``maddpg.train_jit`` is ``maddpg.train`` here).

    PYTHONPATH=src python examples/quickstart_torch.py [--fast]                # the card
    PYTHONPATH=src python examples/quickstart_torch.py --fast --device cpu     # no card
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import env as env_lib, evaluate, maddpg  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="2-minute demo run")
    ap.add_argument("--eds", type=int, default=10)
    ap.add_argument("--models", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    p = env_lib.default_params(num_eds=args.eds, num_models=args.models)
    steps = 1500 if args.fast else 8000
    cfg = maddpg.AlgoConfig(total_steps=steps, batch_size=256 if args.fast else 512,
                            warmup=500 if args.fast else 1500)

    print(f"IIoT env: {args.eds} EDs, 3 ESs, {args.models} AIGC models "
          f"on {device}")
    print(f"training MADDPG-MATO for {steps} env steps ...", flush=True)
    t0 = time.time()
    ts, metrics = maddpg.train(torch.Generator(device=device).manual_seed(0),
                               p, cfg, device=device)
    reward = metrics["reward"].cpu()
    print(f"trained in {time.time() - t0:.0f}s; "
          f"reward {float(reward[:100].mean()):.1f} -> "
          f"{float(reward[-100:].mean()):.1f}")

    def gen():
        return torch.Generator(device=device).manual_seed(1)

    rows = [("maddpg-mato", evaluate.evaluate_policy(
        gen(), "actor", p, cfg=cfg, params=ts.actor, device=device))]
    for name in ("random", "greedy"):
        rows.append((name, evaluate.evaluate_policy(gen(), name, p,
                                                    device=device)))

    print(f"\n{'algorithm':15s} {'latency(s)':>10s} {'energy(J)':>10s} "
          f"{'completion':>10s} {'switch(s)':>10s}")
    for name, m in rows:
        print(f"{name:15s} {m['latency']:10.3f} {m['energy']:10.3f} "
              f"{m['completion']:10.3f} {m['switch_latency']:10.3f}")


if __name__ == "__main__":
    main()
