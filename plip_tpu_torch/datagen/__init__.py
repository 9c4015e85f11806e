"""Dataset generation helpers: the port's copies of ``plip_tpu.datagen``."""
