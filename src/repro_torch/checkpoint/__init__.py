from repro_torch.checkpoint.ckpt import (latest_step,  # noqa: F401
                                         load_checkpoint, save_checkpoint)
