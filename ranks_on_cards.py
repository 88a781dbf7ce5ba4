"""The cross-rank phases of ``chip_smoke.py`` on a host with a card for
every rank, where the ranks take NCCL (``parallel.spawn.choose_backend``).

``chip_smoke.py`` runs these phases on one card, where both ranks share
``cuda:0`` over gloo. Here each rank has a card of its own:

- ``tp_phases``: TP = 2 GPT-2-small served by ``TensorParallelPagedEngine``
  (fp32 tokens identical to tp = 1 with equal decode steps, bf16 tokens/s)
  and trained with FusedAdam (fp32 losses and gathered gradients against
  tp = 1, bf16 step ms), with the collectives' host time;
- ``ddp_syncbn``: ResNet-50 with SyncBatchNorm and DDP over 2 ranks
  against one rank on the whole batch, and a forced overflow skipped on
  both ranks.

Each phase prints its JSON line; a failed check raises. Needs two or more
cards; prints the card's name and power limit first. TF32 is off, as in
``chip_smoke.py``. A function check: the ranks' times are not a scaling
measurement.

Run:  python3 ranks_on_cards.py
"""

import sys

import torch


def main() -> int:
    if torch.cuda.device_count() < 2:
        print("ranks_on_cards: needs two cards, one a rank", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from apex_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    print(f"build_s {_build.build_all()}", flush=True)
    cs.warm_card()
    cs.tp_phases(smi)
    cs.ddp_syncbn(smi)
    print("ranks_on_cards: every check passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
