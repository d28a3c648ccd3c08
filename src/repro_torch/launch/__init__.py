"""Launch layer of the port: the training and serving command lines
(``python -m repro_torch.launch.train corais``, ``python -m
repro_torch.launch.serve``), counterparts of ``repro/launch/train.py`` and
``serve.py``. Both run on CUDA unless given ``--device cpu``. ``mesh.py``
builds the LM steps' ("data", "model") mesh and the fleet mesh of the
sharded rollouts and the data-parallel trainer; ``steps.py`` the LM's
train, prefill and decode steps, meshless or on a mesh."""
