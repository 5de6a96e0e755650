"""End-to-end training on the PyTorch port: the counterpart of
``examples/train_lm.py``. A ~100M-class model of any assigned family with
the full stack: the deterministic data pipeline, AdamW, checkpoint and
restart, int8 gradient compression with error feedback, and the
OpenOptics inter-pod all-reduce time. On a CUDA card by default; the
``small`` preset has the head dim of 64 that the flash kernel needs
(``tiny``, head dim 16, runs with ``--device cpu``).

    python examples/train_lm_torch.py --arch olmo-1b --steps 200 [--device cpu]
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.train import train  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="small", choices=["tiny", "small"])
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" / "train_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(arch=args.arch, preset=args.preset, steps=args.steps,
                global_batch=8, seq=128, ckpt_dir=args.ckpt_dir,
                ckpt_every=50, resume=True, compression="int8",
                device=args.device)
    print(f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"in {out['wall_s']:.0f}s on {out['device']}")
