import numpy as np
import torch

from cst_captioning_tpu_torch.serving.producer import stage_twice


def summarize(batch):
    dev = stage_twice(batch)
    host = dev.cpu().numpy()            # one explicit, visible readback
    total = np.sum(host)
    kept = torch.where(dev > 0, dev, torch.zeros_like(dev))   # fixed shape
    return total, kept
