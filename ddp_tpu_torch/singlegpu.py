"""Single-card training, the port's ``singlegpu.py``:

    python -m ddp_tpu_torch.singlegpu <total_epochs> <save_every> \\
        [--batch_size N] [--resident] [--device cpu]
"""
from ddp_tpu_torch.cli import main

if __name__ == "__main__":
    main()
