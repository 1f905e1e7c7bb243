"""Host audio IO: decoding (``audio``), the native decoder (``native``) and
host -> device staging (``staging``); port of ``vae_hmc_tpu.io``."""
