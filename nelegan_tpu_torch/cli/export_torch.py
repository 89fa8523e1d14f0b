"""Export a training checkpoint to the reference's torch format.

Counterpart of `nelegan_tpu/cli/export_torch.py`: a checkpoint of the port
(``.ptstate``) or of the reference package (``.msgpack``), or a directory
whose `latest` names one, becomes a reference ``chkpt_*.pt`` (reference:
train_nele.py:272-277) holding 'enhance-model' and, unless
`--generator-only`, 'intel-model' and 'quality-model'.  The models are sized
by the checkpoint's config.

    python -m nelegan_tpu_torch.cli.export_torch \\
        --checkpoint ./chkpt --out chkpt_GD.pt [--generator-only] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse

from nelegan_tpu_torch.device import resolve_device
from nelegan_tpu_torch.models.convert import save_reference_checkpoint
from nelegan_tpu_torch.train.checkpoint import (config_for_checkpoint,
                                                load_checkpoint)
from nelegan_tpu_torch.train.gan import init_train_state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint dir (uses `latest`), .ptstate or "
                        ".msgpack file")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--generator-only", action="store_true",
                   help="write only enhance-model (inference needs no Ds)")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a GPU pass 'cpu' explicitly")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_for_checkpoint(args.checkpoint)
    state, _, epoch, _ = load_checkpoint(args.checkpoint,
                                         init_train_state(cfg, 0, device))
    slots = {"gen": state.gen.state_dict()}
    if not args.generator_only:
        slots.update(d=state.d.state_dict(), dq=state.dq.state_dict())
    save_reference_checkpoint(args.out, slots)
    print(f"wrote {args.out} (epoch {epoch}, "
          f"{'G only' if args.generator_only else 'G + both Ds'})")


if __name__ == "__main__":
    main()
