"""Scale-out on ``torch.distributed``: the port of ``plip_tpu.parallel``,
data parallelism and Megatron-style tensor parallelism over a ``dp x tp``
mesh (``mesh``; the collectives and the tp autograd functions in
``distributed``)."""
