import torch


def stage(x):
    """Puts a host batch on the card."""
    return x.to("cuda")


def stage_twice(x):
    return stage(x)
