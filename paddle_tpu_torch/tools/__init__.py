"""Command-line tools of paddle_tpu_torch, each run as
``python -m paddle_tpu_torch.tools.<name>``."""
