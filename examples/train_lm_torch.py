"""End-to-end LM training through the PyTorch port: trains a ~100M-class
model for a few hundred steps through ``repro_torch.launch.train``
(deterministic pipeline, atomic checkpoints with auto-resume, straggler
monitor). The loss must visibly fall. Counterpart of ``train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py                 # the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu    # no card
    PYTHONPATH=src python examples/train_lm_torch.py --full          # smollm-135m

The same entry point trains any of the 10 archs: --arch mixtral_8x7b etc.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import train  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as ckpt:
        _, losses = train(
            args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
            use_reduced=not args.full, ckpt_dir=ckpt, ckpt_every=100,
            device=args.device,
        )
    drop = losses[0] - losses[-1]
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} (drop {drop:.3f})")
    assert drop > 0.3, "training failed to reduce loss"
    print("OK: end-to-end training path works")


if __name__ == "__main__":
    main()
