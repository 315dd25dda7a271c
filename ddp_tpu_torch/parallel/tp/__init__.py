"""Tensor-model parallelism over the ``(data, model)`` rank grid
(counterpart of ``ddp_tpu/parallel/tp/``): ``plan.py`` is the sharding
planner (a model's TP_RECIPE -> the split dimension of each parameter, and
the plan table), ``layers.py`` the sharded compute (column/row-parallel
linear and conv over ``ops/layers.py``, Megatron's f/g pair as autograd
Functions over the model group).  ``python -m ddp_tpu_torch.parallel.tp``
prints a plan's table."""
