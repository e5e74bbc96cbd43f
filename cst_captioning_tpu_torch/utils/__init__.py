from cst_captioning_tpu_torch.utils.logging import EventLogger

__all__ = ["EventLogger"]
