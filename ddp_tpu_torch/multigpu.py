"""Data-parallel training, the port's ``multigpu.py``: one process per
rank, NCCL on the card and gloo on the CPU.

    python -m ddp_tpu_torch.multigpu <total_epochs> <save_every> \
        [--batch_size N] [--resident] [--device cpu] [--spawn N]

Without a rendezvous environment it spawns one rank per visible card (on
the CPU, world 1 unless ``--spawn N``); under ``torchrun`` it is one rank.
"""
from ddp_tpu_torch.cli import main_multi

if __name__ == "__main__":
    main_multi()
