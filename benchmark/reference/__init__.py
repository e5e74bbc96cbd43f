"""The plain reference that decides ``correct``: float32 PyTorch with
TF32 off (``model.py``), the consensus reward in plain Python
(``reward.py``), the batch order and collation worked out again from the
pool's files (``batches.py``) and the rollout noise (``noise.py``). It
imports nothing of the port and takes nothing the port made: weights
come from ``benchmark.weights``, data from the pool's files, and the
port's outputs are read only to judge them.
"""
