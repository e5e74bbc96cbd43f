"""Faults that the training kinds share, planted under the timed path
for the control's evidence and the tests; each kind's own are in its
``FAULTS`` (``kinds/<kind>.py``), each a context manager that patches
one function of the port for the run inside it."""

from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def unchanged():
    """A training step that leaves its state unchanged."""
    def apply_gradients(self, grads):
        self.step += 1
        return self

    with mock.patch("cst_captioning_tpu_torch.train.state.TrainState."
                    "apply_gradients", apply_gradients):
        yield
