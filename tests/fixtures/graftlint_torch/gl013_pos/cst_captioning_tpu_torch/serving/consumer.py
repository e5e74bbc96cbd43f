import numpy as np
import torch

from cst_captioning_tpu_torch.serving.producer import stage_twice


def summarize(batch):
    dev = stage_twice(batch)
    total = np.sum(dev)                 # an implicit transfer, two calls deep
    keep = dev[dev > 0]                 # a boolean CUDA mask: data-dependent
    idx = torch.nonzero(dev)            # data-dependent shape
    return total, keep, idx
