"""Data-parallel scale-out on ``torch.distributed``: the port of
``plip_tpu.parallel`` (the dp half; tensor parallelism is ROADMAP item 9b)."""
